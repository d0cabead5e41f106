// Fused guided sampler for Hopper (sm_90a): one row's whole masked-sampler
// pipeline over the vocabulary in one thread-block cluster.
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
//   top-p (only when top_p < 1): the cutoff `lo` of the TPU kernel's
//     30-step bisection of mass(t) = sum_{x - m >= t} e; ties KEPT
//   sel = kept & i != forbid
//   greedy token = first index of max over sel (2^24 when sel is empty)
//   sampled token = smallest i whose inclusive CDF of w = sel ? e : 0
//                   exceeds u * sum(w) (Vp - 1 when none does)
// and writes [token, any_tok].  `u` is an input (the wrapper draws it
// from a torch.Generator), so kernel and plain version agree token for
// token on the same u.  The dead-end EOS override and the DFA transition
// stay in the wrapper, as in the TPU version.
//
// What bounds it on this card: the row (V = 151936 f32 logits + int16
// budgets, ~0.9 MB) must be read from device memory once — bytes; at a
// decode step's 10 rows that is ~3 µs at the card's rate, the same order
// as the launch and the cluster's exchanges.  The design:
//
// * One cluster of c CTAs per row (ops/guided_sampler.py::sampler_plan
//   picks c, 1-16, so that the B clusters run in one wave where they
//   fit: c = 8 at B = 10), each CTA on its own SM.  CTA `rank` owns the
//   slice [rank * slice, +slice) of the row (8-element aligned).
// * The slice is read once: one thread issues 1D bulk copies (TMA) of
//   logits and budgets into shared memory in stages of 4096 tokens, each
//   on its own mbarrier, and the CTA turns each stage into x in place as
//   it lands (rows that are not 16-byte aligned are read by the threads).
// * Cluster exchanges push: each CTA stores its partial into every peer's
//   shared memory with st.async, which completes on the peer's mbarrier
//   for that exchange; a CTA reads the c partials it received, locally and
//   in rank order, so every CTA holds the same bits.  No CTA reads another
//   CTA's shared memory; each waits for every store into its own before it
//   goes on (the barriers are armed, and the cluster synchronised once,
//   while the first stages load), so none exits while a peer still writes.
// * Each thread owns a contiguous chunk of the slice (chunk = 4 mod 8
//   floats apart, so float4 reads are free of bank conflicts) and keeps a
//   bit mask of its live tokens: every later pass visits those alone, so
//   a row with few allowed tokens (most of a JSON decision's steps) costs
//   little past the load.
// * Top-p: instead of 30 bisection passes, up to 6 passes of a 5-level
//   tree.  From (lo, hi), the 31 thresholds of the next five levels are
//   formed exactly as the f32 recurrence mid = 0.5f * (lo + hi) forms
//   them on each path; one pass puts each live token of the window
//   [lo, hi) into the leaf its comparisons reach (thread-private bins,
//   summed in a fixed order; z rides in bin 0 of the first pass), and the
//   five decisions mass >= top_p * z are taken on suffix sums of the
//   bins, the mass above hi carried from the pass before.  Once a pass's
//   window holds at most one token cluster-wide, the remaining levels are
//   the recurrence itself on that token, with no exchange (the same bits).
// * One pass for the greedy token and the weights: each thread keeps
//   (max, first index) over its selected tokens and writes the running sum
//   of w over x where w > 0; a block scan of the chunk sums, one exchange
//   of (amax, first, CTA sum).
// * Inverse CDF without bisection: the prefix of CTA sums in rank order
//   picks the CTA, its scan the thread, and one warp finds in that chunk
//   the first weighted token whose prefix exceeds u * total — the index
//   the bisection defines.  Sums run in another order than the plain
//   version's, so a target within rounding of a CDF step (or a mass
//   within rounding of the cutoff) can decide otherwise; every answer is
//   still a selected token.
// All sums run in a fixed order (no atomics): two calls give the same bits.
// Rank 0 writes any_tok and the greedy token (or Vp - 1); the CTA that
// holds the sampled token writes it.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr int kStage = 8 * kThreads;         // tokens a bulk-copy stage: a group each thread
constexpr int kMaxStages = 16;
constexpr int kLevels = 5;                   // bisection levels a tree pass decides
constexpr int kPasses = 6;                   // 6 x 5 = the TPU kernel's 30 levels
constexpr int kBins = 1 << kLevels;          // leaves; bin 0 counts for no threshold
constexpr int kExchanges = kPasses + 2;      // m, the top-p passes, the greedy/CDF one
constexpr float kToppRange = 30.f;
constexpr float kLive = bcg::kNegInf * 0.5f;
constexpr int kNoToken = 1 << 24;            // greedy sentinel of an empty selection
constexpr int kMaskWords = 3;                // a thread's chunk: at most 96 tokens

// ---- mbarriers, bulk copies and stores into a peer's shared memory.

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem(bar)) : "memory");
}

// This thread's arrival, with `bytes` more to come from copies and stores.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem(bar)),
               "r"(bytes) : "memory");
}

// Each barrier completes one phase only: wait for phase 0.
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
      " @!p bra WAIT_%=;\n}" ::"r"(smem(bar)) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem(dst)), "l"(src), "r"(bytes), "r"(smem(bar)) : "memory");
}

// The address of `p` in peer `rank`'s shared memory.
__device__ __forceinline__ uint32_t peer(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem(p)), "r"(rank));
  return r;
}

// Store 2 or 4 words into peer `rank`'s copy of `slot`, counted on its
// copy of `bar`.
__device__ __forceinline__ void push2(const void* slot, int rank, uint32_t a, uint32_t b,
                                      const uint64_t* bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];"
               ::"r"(peer(slot, rank)), "r"(a), "r"(b), "r"(peer(bar, rank)) : "memory");
}

__device__ __forceinline__ void push4(const void* slot, int rank, uint32_t a, uint32_t b,
                                      uint32_t c, uint32_t d, const uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(peer(slot, rank)), "r"(a), "r"(b), "r"(c), "r"(d), "r"(peer(bar, rank)) : "memory");
}

// Floats as ints of the same order, for the integer warp reductions
// (the map is its own inverse).
__device__ __forceinline__ int ord(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7fffffff);
}

__device__ __forceinline__ float unord(int i) {
  return __int_as_float(i ^ ((i >> 31) & 0x7fffffff));
}

// Lane n (1..31) of a warp forms node n of the heap-ordered thresholds of
// the five bisection levels below (lo, hi), writes it to thr[n] and
// returns it: node n's path from the root is n's bits under its leading
// one (1 = the upper half), each mid formed as the recurrence forms it.
__device__ __forceinline__ float make_tree(float lo, float hi, float* thr) {
  const int node = threadIdx.x & 31;
  float a = lo, b = hi;
  for (int l = 30 - __clz(node | 1); l >= 0; --l) {
    const float mid = 0.5f * (a + b);
    if ((node >> l) & 1) a = mid;
    else b = mid;
  }
  const float t = 0.5f * (a + b);
  if (node > 0) thr[node] = t;
  return t;
}

__global__ void __launch_bounds__(kThreads, 1)
guided_sampler_kernel(const float* __restrict__ logits,        // [B, V]
                      const int16_t* __restrict__ min_budget,  // [n_dfa, n_states, V]
                      const int* __restrict__ dfa_ids,         // [B]
                      const int* __restrict__ states,          // [B], clamped >= 0
                      const int* __restrict__ meta_i,          // [B, 4]
                      const float* __restrict__ meta_f,        // [B, 2]
                      int* __restrict__ out_tok,               // [B]
                      bool* __restrict__ out_any,              // [B]
                      int V, int Vp, int n_states, int eos_id, float top_p,
                      int slice, int chunk) {
  // Dynamic: x for kThreads * chunk tokens, then the budgets' staging
  // (the load phase) sharing its space with the top-p bins (after it).
  extern __shared__ __align__(16) float dyn[];
  __shared__ __align__(8) uint64_t stage_bar[kMaxStages];
  __shared__ __align__(8) uint64_t xbar[kExchanges];
  // What the CTAs of the cluster push, one slot a CTA: exchange 0's
  // (m, any); the passes' bins, warp w's (w, w + 16) side by side, in two
  // alternating sets; the last exchange's (amax, first, CTA sum).
  __shared__ __align__(8) uint32_t box0[kMaxCluster][2];
  __shared__ __align__(8) float box_bins[2][kMaxCluster][kBins];
  __shared__ __align__(16) uint32_t box7[kMaxCluster][4];
  // With the passes' bins: the CTA's count of window tokens and, when it
  // holds one, that token's (d, e).
  __shared__ __align__(16) uint32_t box_w[2][kMaxCluster][4];
  __shared__ float wsum[kWarps];
  __shared__ int red_i[kWarps], wflag[kWarps], wcount[kWarps];
  __shared__ float one_de[2];
  __shared__ float thr[kWarps][kBins];   // each warp's tree: heap-ordered thresholds 1..31
  __shared__ float cand_ex[kWarps];
  __shared__ int cand_t[kWarps];
  __shared__ uint32_t cand_w[kWarps][kMaskWords];

  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int row = blockIdx.x / c;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* xs = dyn;                                        // [kThreads * chunk]: x, then w's prefix
  float* bins = dyn + kThreads * chunk;                   // [kBins][kThreads], top-p only
  const int16_t* staged = reinterpret_cast<const int16_t*>(bins);

  const int s0 = rank * slice;
  const int n = max(0, min(slice, V - s0));
  const int budget_left = meta_i[row * 4 + 0];
  const int forbid = meta_i[row * 4 + 1];
  const int greedy = meta_i[row * 4 + 2];
  const int eos_ok = meta_i[row * 4 + 3];
  const float temp = meta_f[row * 2 + 0];
  const float u = meta_f[row * 2 + 1];
  const bool use_topp = top_p < 1.f;
  const float* lrow = logits + (long long)row * V + s0;
  const int16_t* mrow =
      min_budget + ((long long)dfa_ids[row] * n_states + states[row]) * V + s0;
  const bool bulk =
      ((reinterpret_cast<uintptr_t>(lrow) | reinterpret_cast<uintptr_t>(mrow)) & 15) == 0;
  const int nbulk = bulk ? (n & ~7) : 0;       // tokens the bulk copies bring
  const int nstages = (nbulk + kStage - 1) / kStage;

  if (tid == 0) {
    for (int k = 0; k < nstages; ++k) mbar_init(&stage_bar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // Logits from one thread, budgets from another: the budgets' address
  // waits on the row's DFA state, the logits' does not.
  if (tid == 0) {
    for (int k = 0; k < nstages; ++k) {
      const int e0 = k * kStage, ne = min(kStage, nbulk - e0);
      mbar_expect(&stage_bar[k], 6 * ne);
      bulk_load(xs + e0, lrow + e0, 4 * ne, &stage_bar[k]);
    }
    // The exchanges' barriers, each armed for the c partials it is to
    // receive; they exist before any peer stores into them (the cluster's
    // wait comes after the load).
    for (int k = 0; k < kExchanges; ++k) mbar_init(&xbar[k]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect(&xbar[0], c * 8);
    for (int p = 0; p < kPasses; ++p)
      mbar_expect(&xbar[1 + p], use_topp ? c * (4 * kBins + 16) : 0);
    mbar_expect(&xbar[kExchanges - 1], c * 16);
  } else if (tid == 32) {
    for (int k = 0; k < nstages; ++k) {
      const int e0 = k * kStage, ne = min(kStage, nbulk - e0);
      bulk_load(bins + e0 / 2, mrow + e0, 2 * ne, &stage_bar[k]);
    }
  }
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");

  // ---- x from each stage as it lands; the local max and any.
  float mloc = bcg::kNegInf;
  bool anyloc = false;
  for (int k = 0; k < nstages; ++k) {
    mbar_wait(&stage_bar[k]);
    const int g = k * kThreads + tid;   // this thread's 8-token group of the stage
    if (8 * g < nbulk) {
      float4* xp = reinterpret_cast<float4*>(xs + 8 * g);
      const int4 mv = reinterpret_cast<const int4*>(staged)[g];
      const int w[4] = {mv.x, mv.y, mv.z, mv.w};
      bool gate[8], anyg = false;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int mb = (j & 1) ? (w[j >> 1] >> 16) : (int)(int16_t)(w[j >> 1] & 0xffff);
        const bool ok = mb <= budget_left;
        anyloc |= ok;
        gate[j] = (s0 + 8 * g + j == eos_id) ? (eos_ok > 0) : ok;
        anyg |= gate[j];
      }
      if (anyg) {   // else the whole group is -1e30
        const float4 la = xp[0], lb = xp[1];
        const float lg[8] = {la.x, la.y, la.z, la.w, lb.x, lb.y, lb.z, lb.w};
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x[j] = gate[j] ? __fdiv_rn(lg[j], temp) : bcg::kNegInf;
          mloc = fmaxf(mloc, x[j]);
        }
        xp[0] = make_float4(x[0], x[1], x[2], x[3]);
        xp[1] = make_float4(x[4], x[5], x[6], x[7]);
      } else {
        xp[0] = xp[1] = make_float4(bcg::kNegInf, bcg::kNegInf, bcg::kNegInf, bcg::kNegInf);
      }
    }
  }
  // The rest (an unaligned row, the tail of an off-lane V) by the threads,
  // and the padding of the last chunks, which never selects.
  for (int i = nbulk + tid; i < kThreads * chunk; i += kThreads) {
    float x = bcg::kNegInf;
    if (i < n) {
      const bool ok = (int)mrow[i] <= budget_left;
      anyloc |= ok;
      if ((s0 + i == eos_id) ? (eos_ok > 0) : ok) x = __fdiv_rn(lrow[i], temp);
      mloc = fmaxf(mloc, x);
    }
    xs[i] = x;
  }

  // The CTA's (m, any), then exchange 0.
  const int m_w = __reduce_max_sync(0xffffffffu, ord(mloc));
  const int any_w = __any_sync(0xffffffffu, anyloc);
  if (lane == 0) {
    red_i[warp] = m_w;
    wflag[warp] = any_w;
  }
  float tk = use_topp ? make_tree(-kToppRange, 1e-6f, thr[warp]) : 0.f;
  __syncthreads();
  // This thread's contiguous chunk of the slice, and the bit mask of its
  // live tokens: the later passes visit those alone, in order.
  const int cnt = max(0, min(chunk, n - tid * chunk));
  float* xc = xs + tid * chunk;
  uint32_t live_m[kMaskWords] = {};
#pragma unroll
  for (int q = 0; q < 8 * kMaskWords; ++q) {
    if (4 * q < cnt) {   // past cnt x is -1e30
      const float4 v = *reinterpret_cast<const float4*>(xc + 4 * q);
      const uint32_t nib = (v.x > kLive) | (v.y > kLive) << 1 | (v.z > kLive) << 2 |
                           (v.w > kLive) << 3;
      live_m[q >> 3] |= nib << (4 * (q & 7));
    }
  }
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
  if (warp == 0) {
    const int m_cta =
        __reduce_max_sync(0xffffffffu, lane < kWarps ? red_i[lane] : ord(bcg::kNegInf));
    const int any_cta = __any_sync(0xffffffffu, lane < kWarps && wflag[lane]);
    if (lane < c) push2(&box0[rank][0], lane, (uint32_t)m_cta, (uint32_t)any_cta, &xbar[0]);
  }
  mbar_wait(&xbar[0]);
  int mk = ord(bcg::kNegInf), any = 0;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q < c) {
      mk = max(mk, (int)box0[q][0]);
      any |= box0[q][1];
    }
  }
  const float m = unord(mk);

  // ---- Top-p cutoff: up to 6 passes of a 5-level threshold tree.  The window
  // mask keeps the live tokens of [lo, hi); a token that leaves it never
  // comes back.
  float lo_t = 0.f;
  if (use_topp) {
#pragma unroll 1
    for (int k = 0; k < kBins; ++k) bins[k * kThreads + tid] = 0.f;
    uint32_t win_m[kMaskWords];
#pragma unroll
    for (int wd = 0; wd < kMaskWords; ++wd) win_m[wd] = live_m[wd];
    float lo = -kToppRange, hi = 1e-6f, mass_hi = 0.f, t_mass = 0.f;
    const float* tw = thr[warp];
    for (int pass = 0; pass < kPasses; ++pass) {
      float z = 0.f, d_in = 0.f, e_in = 0.f;
      bool wrote = false;
      int n_in = 0;
#pragma unroll
      for (int wd = 0; wd < kMaskWords; ++wd) {
        for (uint32_t bits = win_m[wd]; bits; bits &= bits - 1) {
          const int j = 32 * wd + __ffs(bits) - 1;
          const float d = xc[j] - m;
          const bool in = d >= lo && d < hi;   // above hi: carried in mass_hi
          if (!in) win_m[wd] &= ~(1u << (j & 31));
          if (pass == 0 || in) {
            const float e = expf(d);
            z += e;
            if (in) {
              ++n_in;
              d_in = d;
              e_in = e;
              int node = 1;
#pragma unroll
              for (int l = 0; l < kLevels; ++l) node = 2 * node + (d >= tw[node] ? 1 : 0);
              if (node > kBins) {
                bins[(node - kBins) * kThreads + tid] += e;
                wrote = true;
              }
            }
          }
        }
      }
      if (pass == 0 && z > 0.f) {
        bins[tid] = z;   // bin 0 carries z in the first pass
        wrote = true;
      }
      wrote = __any_sync(0xffffffffu, wrote);
      const int n_w = __reduce_add_sync(0xffffffffu, n_in);
      if (n_in == 1) {   // read only when this is the CTA's one window token
        one_de[0] = d_in;
        one_de[1] = e_in;
      }
      if (lane == 0) {
        wflag[warp] = wrote;
        wcount[warp] = n_w;
      }
      __syncthreads();
      // The CTA's bins, each summed over the threads of the warps that
      // wrote, in a fixed order (the others hold zeros), and zeroed again;
      // then pushed to every CTA of the cluster.  The exchange completes
      // only after every warp pushed, so after every warp read its bins.
      const int b = pass & 1;
      const unsigned flagged = __ballot_sync(0xffffffffu, lane < kWarps && wflag[lane]);
      float v2[2] = {0.f, 0.f};   // bins warp and warp + 16
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        for (unsigned f = flagged; f; f &= f - 1) {
          float* p = &bins[(warp + kWarps * h) * kThreads + (__ffs(f) - 1) * 32 + lane];
          v2[h] += *p;
          *p = 0.f;
        }
        if (flagged) v2[h] = bcg::warp_sum(v2[h]);
      }
      if (lane < c)
        push2(&box_bins[b][rank][2 * warp], lane, __float_as_uint(v2[0]),
              __float_as_uint(v2[1]), &xbar[1 + pass]);
      if (warp == 0) {
        const int n_cta = __reduce_add_sync(0xffffffffu, lane < kWarps ? wcount[lane] : 0);
        if (lane < c)
          push4(&box_w[b][rank][0], lane, (uint32_t)n_cta, __float_as_uint(one_de[0]),
                __float_as_uint(one_de[1]), 0u, &xbar[1 + pass]);
      }
      mbar_wait(&xbar[1 + pass]);
      // Every warp alike: lane k holds the cluster's mass in bin k, the
      // CTAs in rank order.
      float cb = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < c) cb += box_bins[b][q][2 * (lane & (kWarps - 1)) + (lane >> 4)];
      if (pass == 0) t_mass = top_p * __shfl_sync(0xffffffffu, cb, 0);
      if (lane == 0) cb = 0.f;
      float suf = cb;   // suffix sums over the bins
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += t;
      }
      // Lane n decides node n: at level l it sits left of leaf
      // (2 (n - 2^l) + 1) 2^(4 - l), so its mass is the suffix from there
      // plus the mass above hi.  Then the five decisions along the path:
      // lo is the last node kept, hi the last one not, with its mass.
      const int lvl = 31 - __clz(lane | 1);
      const int pos = ((2 * (lane - (1 << lvl)) + 1) << (kLevels - 1 - lvl)) & 31;
      const float mass = mass_hi + __shfl_sync(0xffffffffu, suf, pos);
      const unsigned keep = __ballot_sync(0xffffffffu, lane > 0 && mass >= t_mass);
      int node = 1, lo_node = 0, hi_node = 0;
#pragma unroll
      for (int l = 0; l < kLevels; ++l) {
        const bool k = (keep >> node) & 1;
        if (k) lo_node = node;
        else hi_node = node;
        node = 2 * node + (k ? 1 : 0);
      }
      const float t_lo = __shfl_sync(0xffffffffu, tk, lo_node);
      const float t_hi = __shfl_sync(0xffffffffu, tk, hi_node);
      const float m_hi = __shfl_sync(0xffffffffu, mass, hi_node);
      if (lo_node) lo = t_lo;
      if (hi_node) {
        hi = t_hi;
        mass_hi = m_hi;
      }
      // At most one token in this pass's window, cluster-wide: the bins
      // of every later level hold that token's e or nothing, so the
      // remaining levels are the recurrence itself, with no exchange (the
      // same bits as the passes would give).
      int n_all = 0;
      float d1 = 0.f, e1 = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < c) {
          const int nq = (int)box_w[b][q][0];
          n_all += nq;
          if (nq == 1) {
            d1 = __uint_as_float(box_w[b][q][1]);
            e1 = __uint_as_float(box_w[b][q][2]);
          }
        }
      }
      if (n_all <= 1) {
        for (int l = 0; l < (kPasses - 1 - pass) * kLevels; ++l) {
          const float mid = 0.5f * (lo + hi);
          const float mass_mid = mass_hi + (n_all == 1 && d1 >= mid && d1 < hi ? e1 : 0.f);
          if (mass_mid >= t_mass) {
            lo = mid;
          } else {
            hi = mid;
            mass_hi = mass_mid;
          }
        }
        break;
      }
      __syncwarp();
      if (pass + 1 < kPasses) tk = make_tree(lo, hi, thr[warp]);
      __syncwarp();
    }
    lo_t = lo;
  }

  // ---- One pass over the live tokens: greedy (max, first index) over
  // sel and the weights; where w > 0 (the mask w_m) the running sum of w
  // is written over x.
  const int i0 = s0 + tid * chunk;
  float amax = bcg::kNegInf, s = 0.f;
  int first = kNoToken;
  uint32_t w_m[kMaskWords] = {};
#pragma unroll
  for (int wd = 0; wd < kMaskWords; ++wd) {
    for (uint32_t bits = live_m[wd]; bits; bits &= bits - 1) {
      const int j = 32 * wd + __ffs(bits) - 1;
      const float x = xc[j];
      const float d = x - m;
      const int i = i0 + j;
      if ((!use_topp || d >= lo_t) && !(i == forbid && forbid >= 0)) {
        if (x > amax) {
          amax = x;
          first = i;
        }
        const float w = expf(d);
        if (w > 0.f) {
          s += w;
          xc[j] = s;
          w_m[wd] |= 1u << (j & 31);
        }
      }
    }
  }
  // (amax, first) over the block, and the prefix of the chunk sums.
  const int ak = ord(amax);
  const int ak_w = __reduce_max_sync(0xffffffffu, ak);
  const int first_w = __reduce_min_sync(0xffffffffu, ak == ak_w ? first : kNoToken);
  float winc = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, winc, o);
    if (lane >= o) winc += t;
  }
  float wexc = __shfl_up_sync(0xffffffffu, winc, 1);
  if (lane == 0) wexc = 0.f;
  __syncthreads();
  if (lane == 0) {
    red_i[warp] = ak_w;
    wflag[warp] = first_w;
  }
  if (lane == 31) wsum[warp] = winc;
  __syncthreads();
  const int ak_l = lane < kWarps ? red_i[lane] : ord(bcg::kNegInf);
  const int ak_cta = __reduce_max_sync(0xffffffffu, ak_l);
  const int f_cta =
      __reduce_min_sync(0xffffffffu, lane < kWarps && ak_l == ak_cta ? wflag[lane] : kNoToken);
  // The earlier warps' sums: every warp scans the warp sums alike.
  float woff = lane < kWarps ? wsum[lane] : 0.f;
#pragma unroll
  for (int o = 1; o < kWarps; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, woff, o);
    if (lane >= o) woff += t;
  }
  const float off = warp > 0 ? __shfl_sync(0xffffffffu, woff, warp - 1) : 0.f;
  const float excl = off + wexc;
  if (warp == kWarps - 1) {   // the last exchange: (amax, first, CTA sum)
    const float sum_cta = __shfl_sync(0xffffffffu, off + winc, 31);
    if (lane < c)
      push4(&box7[rank][0], lane, (uint32_t)ak_cta, (uint32_t)f_cta, __float_as_uint(sum_cta), 0u,
            &xbar[kExchanges - 1]);
  }
  mbar_wait(&xbar[kExchanges - 1]);
  int g_ak = ord(-INFINITY), g_first = kNoToken;
  float sq[kMaxCluster], total = 0.f;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q < c) {
      const int a = (int)box7[q][0], f = (int)box7[q][1];
      if (a > g_ak || (a == g_ak && f < g_first)) {
        g_ak = a;
        g_first = f;
      }
      sq[q] = __uint_as_float(box7[q][2]);
      total += sq[q];
    }
  }
  const float target = u * total;
  float q_prev = 0.f, q_run = 0.f;
  int rstar = -1;
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) {
    if (q < c) {
      if (q == rank) q_prev = q_run;
      q_run += sq[q];
      if (rstar < 0 && q_run > target) rstar = q;
    }
  }

  if (greedy > 0 || rstar < 0) {
    if (rank == 0 && tid == 0) out_tok[row] = greedy > 0 ? g_first : Vp - 1;
  } else if (rstar == rank) {
    // The first thread whose chunk ends past the target (each warp posts
    // its first such thread); if rounding left none, the last thread with
    // weight (each warp posts its last).
    const bool cand = s > 0.f && q_prev + (excl + s) > target;
    const unsigned cbits = __ballot_sync(0xffffffffu, cand);
    const unsigned sbits = __ballot_sync(0xffffffffu, s > 0.f);
    const int pick = cbits ? __ffs(cbits) - 1 : (sbits ? 31 - __clz(sbits) : -1);
    if (lane == pick) {
      cand_t[warp] = cbits ? tid : kThreads + tid;
      cand_ex[warp] = excl;
#pragma unroll
      for (int wd = 0; wd < kMaskWords; ++wd) cand_w[warp][wd] = w_m[wd];
    } else if (lane == 0 && pick < 0) {
      cand_t[warp] = -1;
    }
    __syncthreads();
    if (warp == 0) {
      const int ct = lane < kWarps ? cand_t[lane] : -1;
      const unsigned fw = __ballot_sync(0xffffffffu, ct >= 0 && ct < kThreads);
      const unsigned lw = __ballot_sync(0xffffffffu, ct >= 0);
      const bool fallback = fw == 0;
      const int w1 = fallback ? 31 - __clz(lw) : __ffs(fw) - 1;
      const int t1 = cand_t[w1] - (fallback ? kThreads : 0);
      const float ex = cand_ex[w1];
      // In t1's chunk: the first weighted token whose prefix passes the
      // target (if rounding left none, the last weighted token).
      const float* ac = xs + t1 * chunk;
      int hit = -1, last = -1;
#pragma unroll
      for (int wd = 0; wd < kMaskWords; ++wd) {
        const uint32_t bits = cand_w[w1][wd];
        const bool has = (bits >> lane) & 1;
        const unsigned h = __ballot_sync(
            0xffffffffu, has && !fallback && q_prev + (ex + ac[has ? 32 * wd + lane : 0]) > target);
        if (hit < 0 && h) hit = 32 * wd + __ffs(h) - 1;
        if (bits) last = 32 * wd + 31 - __clz(bits);
      }
      if (lane == 0) out_tok[row] = s0 + t1 * chunk + (hit >= 0 ? hit : last);
    }
  }
  if (rank == 0 && tid == 0) out_any[row] = any != 0;
}

cudaError_t setup() {
  // The dynamic shared memory cap (the block's opt-in limit less the
  // static arrays) and clusters of more than 8, once per device.
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, guided_sampler_kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(guided_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)fa.sharedSizeBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(guided_sampler_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  if (dev < 64) done[dev] = true;
  return cudaSuccess;
}

cudaLaunchConfig_t config(int blocks, int smem_bytes, cudaStream_t stream,
                          cudaLaunchAttribute* attr, int c) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// Clusters of c CTAs with `smem_bytes` of dynamic shared memory that the
// card can hold at once (0 when it cannot hold one); the wrapper's plan
// asks before it launches.
extern "C" int bcg_guided_sampler_max_clusters(int c, int smem_bytes, void* out) {
  int* n = static_cast<int*>(out);
  *n = 0;
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(c, smem_bytes, 0, attr, c);
  err = cudaOccupancyMaxActiveClusters(n, guided_sampler_kernel, &cfg);
  if (err != cudaSuccess) {
    *n = 0;
    cudaGetLastError();   // a cluster shape the card refuses: not sticky
  }
  return cudaSuccess;
}

// dims: [B, V, Vp, n_states, eos_id, c, slice, chunk, smem_bytes], packed
// once for each call shape by the wrapper.
extern "C" int bcg_guided_sampler(const void* logits, const void* min_budget,
                                  const void* dfa_ids, const void* states,
                                  const void* meta_i, const void* meta_f, void* out_tok,
                                  void* out_any, const int* dims, float top_p, void* stream) {
  cudaError_t err = setup();
  if (err != cudaSuccess) return (int)err;
  const int B = dims[0], c = dims[5];
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = config(B * c, dims[8], (cudaStream_t)stream, attr, c);
  err = cudaLaunchKernelEx(&cfg, guided_sampler_kernel, static_cast<const float*>(logits),
                           static_cast<const int16_t*>(min_budget),
                           static_cast<const int*>(dfa_ids), static_cast<const int*>(states),
                           static_cast<const int*>(meta_i), static_cast<const float*>(meta_f),
                           static_cast<int*>(out_tok), static_cast<bool*>(out_any), dims[1],
                           dims[2], dims[3], dims[4], top_p, dims[6], dims[7]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
