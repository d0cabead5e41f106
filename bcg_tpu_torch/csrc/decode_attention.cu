// Decode-step attention over the bf16 KV cache for Hopper (sm_90a).
//
// Replaces: bcg_tpu/ops/decode_attention.py::_decode_kernel (bf16 form;
// wrapper decode_attention).  On the TPU this block never lowered for
// Hkv > 1 and the bf16 decode ran as an XLA einsum; in the port it IS
// the decode step.
//
// Computes, per (batch b, kv head hk), for the group G = H / Hkv query
// rows of that kv head:
//   out[g] = sum_s softmax_s(scale * q[g].k[s], masked)[s] * v[s]
// over the cache k/v [B, S, Hkv, Dh] (S-major: one position's heads are
// adjacent, so consecutive positions of one head sit Hkv*Dh apart).  The
// mask has M rows per batch: 1 (shared by the group, the single-step
// form) or G (one per query row, for a later chunk form).  Arithmetic
// as in the Pallas kernel: -1e30 sentinel, p = exp(s - m) * mask, l over
// the f32 p, p rounded to bf16 for the p.v product, acc / (l==0 ? 1 : l).
//
// What bounds it on this card: the whole cache window is read once per
// step (2 * S * Dh * 2 bytes per kv head) for ~4 * G * S * Dh operations
// — about G / 2 operations per byte, far below the ~295 the tensor cores
// need, so it is bound by memory bytes.  The design streams the cache
// once with 16-byte loads along Dh (16 lanes cover one 256-byte K or V
// row), eight positions in flight per block and all eight of a pass's
// rows loaded before any is used, with the G query rows of the kv head
// sharing every loaded row (no per-head re-read).  Online softmax keeps
// the running max and sum per query row in shared memory.  One block per
// (b, kv head) leaves B * Hkv blocks — 80 at the bench-8b game shape,
// under the 132 SMs; a split-S (flash-decoding) second pass is the next
// step.  Head dim 128; G up to 8.

#include "common.cuh"

namespace {

constexpr int kDh = 128;
constexpr int kMaxG = 8;
constexpr int kThreads = 128;
constexpr int kSlots = kThreads / 16;   // positions in flight (16 lanes x 8 dims each)
constexpr int kTile = 64;               // positions per online-softmax update
constexpr int kPasses = kTile / kSlots;

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,   // [B, H, Dh]
                        const __nv_bfloat16* __restrict__ k,   // [B, S, Hkv, Dh] strided
                        const __nv_bfloat16* __restrict__ v,
                        const uint8_t* __restrict__ mask,      // [B, M, S]
                        __nv_bfloat16* __restrict__ out,       // [B, H, Dh]
                        int S, int H, int Hkv, int M,
                        long long kv_bstride, long long kv_sstride, float scale) {
  __shared__ float sc[kMaxG][kTile];        // scores, then bf16-rounded p
  __shared__ uint8_t mk[kMaxG][kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], al_s[kMaxG];
  __shared__ float red[kSlots][kMaxG][kDh];

  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int slot = tid >> 4, l16 = tid & 15;
  const int d0 = l16 * 8;
  const int warp = tid >> 5, lane = tid & 31;

  float qf[kMaxG][8];
  float acc[kMaxG][8];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) { qf[g][i] = 0.f; acc[g][i] = 0.f; }
    if (g < G) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + ((long long)b * H + hk * G + g) * kDh + d0);
      bcg::bf16x8_to_float(raw, qf[g]);
    }
  }
  if (tid < kMaxG) { m_s[tid] = bcg::kNegInf; l_s[tid] = 0.f; }
  __syncthreads();

  const uint8_t* mrow = mask + (long long)b * M * S;
  const __nv_bfloat16* kb = k + (long long)b * kv_bstride + (long long)hk * kDh + d0;
  const __nv_bfloat16* vb = v + (long long)b * kv_bstride + (long long)hk * kDh + d0;

  for (int s0 = 0; s0 < S; s0 += kTile) {
    // 1. scores: every pass's K row in flight before any is used.
    uint4 kr[kPasses];
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int s = s0 + j * kSlots + slot;
      kr[j] = s < S ? *reinterpret_cast<const uint4*>(kb + (long long)s * kv_sstride)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int sl = j * kSlots + slot;
      const int s = s0 + sl;
      float kf[8];
      bcg::bf16x8_to_float(kr[j], kf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part += qf[g][i] * kf[i];
        part += __shfl_xor_sync(0xffffffffu, part, 8);
        part += __shfl_xor_sync(0xffffffffu, part, 4);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        if (l16 == 0) {
          const uint8_t m = s < S ? mrow[(M == 1 ? 0 : g) * (long long)S + s] : 0;
          mk[g][sl] = m;
          sc[g][sl] = m ? part * scale : bcg::kNegInf;
        }
      }
    }
    __syncthreads();

    // 2. online-softmax update, one warp per query row.
    for (int g = warp; g < G; g += kThreads / 32) {
      const float sa = sc[g][lane], sb = sc[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, bcg::warp_max(fmaxf(sa, sb)));
      const float alpha = expf(m_prev - m_new);
      const float pa = expf(sa - m_new) * (mk[g][lane] ? 1.f : 0.f);
      const float pb = expf(sb - m_new) * (mk[g][lane + 32] ? 1.f : 0.f);
      const float rs = bcg::warp_sum(pa + pb);
      sc[g][lane] = __bfloat162float(__float2bfloat16(pa));
      sc[g][lane + 32] = __bfloat162float(__float2bfloat16(pb));
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = alpha * l_s[g] + rs;
        al_s[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = alpha * acc + p . v over this thread's positions and dims.
    uint4 vr[kPasses];
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int s = s0 + j * kSlots + slot;
      vr[j] = s < S ? *reinterpret_cast<const uint4*>(vb + (long long)s * kv_sstride)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float alpha = al_s[g];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kPasses; ++j) {
      const int sl = j * kSlots + slot;
      float vf[8];
      bcg::bf16x8_to_float(vr[j], vf);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float p = sc[g][sl];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] += p * vf[i];
      }
    }
    __syncthreads();   // sc / al_s are rewritten by the next tile
  }

  // Sum the kSlots partial accumulators, normalise, store bf16.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int i = 0; i < 8; ++i) red[slot][g][d0 + i] = acc[g][i];
  }
  __syncthreads();
  for (int idx = tid; idx < G * kDh; idx += kThreads) {
    const int g = idx / kDh, d = idx % kDh;
    float sum = 0.f;
#pragma unroll
    for (int sl = 0; sl < kSlots; ++sl) sum += red[sl][g][d];
    const float l = l_s[g] == 0.f ? 1.f : l_s[g];
    out[((long long)b * H + hk * G + g) * kDh + d] = __float2bfloat16(sum / l);
  }
}

}  // namespace

extern "C" int bcg_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int S, int H,
                                    int Hkv, int M, long long kv_bstride,
                                    long long kv_sstride, float scale, void* stream) {
  dim3 grid(Hkv, B);
  decode_attention_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, M, kv_bstride, kv_sstride, scale);
  return (int)cudaGetLastError();
}
