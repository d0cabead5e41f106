// Fused guided sampler for Hopper (sm_90a): one row's whole masked-sampler
// pipeline over the vocabulary in one block.
//
// Replaces: bcg_tpu/ops/guided_sampler.py::_sampler_kernel (wrappers
// _sampler_call / make_fused_sampler).
//
// Computes, for batch row r with DFA (dfa_ids[r], states[r]) and per-row
// scalars [budget_left, forbid, greedy, eos_ok] and [temp, u], in order:
//   allowed  = min_budget[dfa, state, i] <= budget_left
//   any_tok  = any(allowed)                      (before the EOS patch)
//   x_i      = gate_i ? logits_i / temp : -1e30  (gate = eos_ok at EOS,
//                                                 allowed elsewhere)
//   m = max x, e_i = x_i > -5e29 ? exp(x_i - m) : 0
//   top-p (only when top_p < 1): 30-step bisection of
//     mass(t) = sum_{x - m >= t} e for the cutoff; ties KEPT
//   sel = kept & i != forbid
//   greedy token = first index of max over sel
//   sampled token = smallest i whose inclusive CDF of w = sel ? e : 0
//                   exceeds u * sum(w) (21-step bisection)
// and writes [token, any_tok].  `u` is an input (the wrapper draws it
// from a torch.Generator), so kernel and plain version agree token for
// token on the same u.  The dead-end EOS override and the DFA transition
// stay in the wrapper, as in the TPU version.
//
// What bounds it on this card: the row (V = 151936 f32 logits + int16
// budgets, ~0.9 MB) must be read from device memory once — bytes.  It
// does not fit the 227 KB of shared memory, so each pass re-reads it;
// after the first pass the row is served from the 50 MB L2.  The design
// is one 1024-thread block per row, coalesced strided passes, and block
// reductions through warp shuffles: the max/any pass, the greedy
// argmax passes, the sum pass, the top-p bisection when on, and the CDF
// bisection (each CDF pass only reads indices up to its midpoint).  This
// is the simple, correct first version; the ~25 passes at top_p = 1
// are the obvious thing to cut (one pass per bisection level over a
// cached per-thread partial-sum table) in a later change.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kToppIters = 30;
constexpr int kCdfIters = 21;
constexpr float kToppRange = 30.f;

struct Row {
  const float* logits;
  const int16_t* minb;
  int budget_left, forbid, eos_ok, eos_id;
  float temp;
};

// x_i exactly as the TPU kernel forms it; `allowed` for any_tok.
__device__ __forceinline__ float gated(const Row& r, int i, bool* allowed) {
  const bool ok = (int)r.minb[i] <= r.budget_left;
  *allowed = ok;
  const bool gate = (i == r.eos_id) ? (r.eos_ok > 0) : ok;
  return gate ? r.logits[i] / r.temp : bcg::kNegInf;
}

struct MaxOp { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinOp { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct SumOp { __device__ float operator()(float a, float b) const { return a + b; } };

template <typename Op>
__device__ float block_reduce(float val, Op op, float* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) val = op(val, __shfl_xor_sync(0xffffffffu, val, o));
  __syncthreads();   // sh may still be read by the previous reduction
  if (lane == 0) sh[warp] = val;
  __syncthreads();
  if (warp == 0) {
    val = sh[lane];   // kWarps == 32
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) val = op(val, __shfl_xor_sync(0xffffffffu, val, o));
    if (lane == 0) sh[kWarps] = val;
  }
  __syncthreads();
  return sh[kWarps];
}

__global__ void __launch_bounds__(kThreads)
guided_sampler_kernel(const float* __restrict__ logits,        // [B, V]
                      const int16_t* __restrict__ min_budget,  // [n_dfa, n_states, V]
                      const int* __restrict__ dfa_ids,         // [B]
                      const int* __restrict__ states,          // [B], clamped >= 0
                      const int* __restrict__ meta_i,          // [B, 4]
                      const float* __restrict__ meta_f,        // [B, 2]
                      int* __restrict__ out,                   // [B, 2]
                      int V, int Vp, int n_states, int eos_id, float top_p) {
  __shared__ float sh[kWarps + 1];
  const int row = blockIdx.x, tid = threadIdx.x;
  Row r;
  r.logits = logits + (long long)row * V;
  r.minb = min_budget + ((long long)dfa_ids[row] * n_states + states[row]) * V;
  r.budget_left = meta_i[row * 4 + 0];
  r.forbid = meta_i[row * 4 + 1];
  const int greedy = meta_i[row * 4 + 2];
  r.eos_ok = meta_i[row * 4 + 3];
  r.eos_id = eos_id;
  r.temp = meta_f[row * 2 + 0];
  const float u = meta_f[row * 2 + 1];
  bool al;

  // Pass 1: any_tok and the row max.
  float mloc = bcg::kNegInf, anyloc = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    mloc = fmaxf(mloc, gated(r, i, &al));
    if (al) anyloc = 1.f;
  }
  const float m = block_reduce(mloc, MaxOp(), sh);
  const float any_tok = block_reduce(anyloc, MaxOp(), sh);

  // Top-p cutoff (log-prob offset `lo` from the max).
  const bool use_topp = top_p < 1.f;
  float lo_t = 0.f;
  if (use_topp) {
    float zl = 0.f;
    for (int i = tid; i < V; i += kThreads) {
      const float x = gated(r, i, &al);
      zl += x > bcg::kNegInf * 0.5f ? expf(x - m) : 0.f;
    }
    const float t_mass = top_p * block_reduce(zl, SumOp(), sh);
    float lo = -kToppRange, hi = 1e-6f;
    for (int it = 0; it < kToppIters; ++it) {
      const float mid = 0.5f * (lo + hi);
      float ml = 0.f;
      for (int i = tid; i < V; i += kThreads) {
        const float x = gated(r, i, &al);
        const float e = x > bcg::kNegInf * 0.5f ? expf(x - m) : 0.f;
        ml += (x - m >= mid) ? e : 0.f;
      }
      const bool keep = block_reduce(ml, SumOp(), sh) >= t_mass;
      lo = keep ? mid : lo;
      hi = keep ? hi : mid;
    }
    lo_t = lo;
  }

  // Greedy: argmax over the kept set minus forbid, first index on ties.
  float amax_l = bcg::kNegInf, wl = 0.f;
  for (int i = tid; i < V; i += kThreads) {
    const float x = gated(r, i, &al);
    const bool kept = use_topp ? (x - m) >= lo_t : x > bcg::kNegInf * 0.5f;
    const bool sel = kept && !(i == r.forbid && r.forbid >= 0);
    amax_l = fmaxf(amax_l, sel ? x : bcg::kNegInf);
    wl += sel ? (x > bcg::kNegInf * 0.5f ? expf(x - m) : 0.f) : 0.f;
  }
  const float amax = block_reduce(amax_l, MaxOp(), sh);
  const float total = block_reduce(wl, SumOp(), sh);
  float first_l = 16777216.f;
  for (int i = tid; i < V; i += kThreads) {
    const float x = gated(r, i, &al);
    const bool kept = use_topp ? (x - m) >= lo_t : x > bcg::kNegInf * 0.5f;
    const bool sel = kept && !(i == r.forbid && r.forbid >= 0);
    if (sel && x == amax) first_l = fminf(first_l, (float)i);
  }
  const float greedy_tok = block_reduce(first_l, MinOp(), sh);

  // Inverse CDF: smallest index whose inclusive kept mass exceeds u * total.
  const float target = u * total;
  int lo = -1, hi = Vp - 1;
  for (int it = 0; it < kCdfIters; ++it) {
    const int mid = (lo + hi) >> 1;   // floor division, as in the TPU kernel
    float bl = 0.f;
    const int upto = mid < V - 1 ? mid : V - 1;
    for (int i = tid; i <= upto; i += kThreads) {
      const float x = gated(r, i, &al);
      const bool kept = use_topp ? (x - m) >= lo_t : x > bcg::kNegInf * 0.5f;
      const bool sel = kept && !(i == r.forbid && r.forbid >= 0);
      bl += sel ? (x > bcg::kNegInf * 0.5f ? expf(x - m) : 0.f) : 0.f;
    }
    const bool up = block_reduce(bl, SumOp(), sh) > target;
    lo = up ? lo : mid;
    hi = up ? mid : hi;
  }

  if (tid == 0) {
    out[row * 2 + 0] = greedy > 0 ? (int)greedy_tok : hi;
    out[row * 2 + 1] = any_tok > 0.f ? 1 : 0;
  }
}

}  // namespace

extern "C" int bcg_guided_sampler(const void* logits, const void* min_budget,
                                  const void* dfa_ids, const void* states,
                                  const void* meta_i, const void* meta_f, void* out,
                                  int B, int V, int Vp, int n_states, int eos_id,
                                  float top_p, void* stream) {
  guided_sampler_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(logits), static_cast<const int16_t*>(min_budget),
      static_cast<const int*>(dfa_ids), static_cast<const int*>(states),
      static_cast<const int*>(meta_i), static_cast<const float*>(meta_f),
      static_cast<int*>(out), V, Vp, n_states, eos_id, top_p);
  return (int)cudaGetLastError();
}
