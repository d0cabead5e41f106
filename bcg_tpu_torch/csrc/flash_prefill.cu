// Flash prefill attention for Hopper (sm_90a), bf16 in, f32 accumulate.
//
// Replaces: bcg_tpu/ops/attention.py::_flash_kernel (the Pallas TPU
// kernel behind _pallas_flash / flash_attention).
//
// Computes, per (batch b, query head h):
//   out[t] = sum_s softmax_s(scale * q[t].k[s], masked)[s] * v[s]
// with GQA (query head h reads kv head h / (H / Hkv)) and an ARBITRARY
// boolean mask [B, T, S] (cached prefix plus left padding — not causal).
// The arithmetic is the Pallas kernel's: masked scores take the finite
// -1e30 sentinel, p = exp(score - m_new) * mask (so a fully masked row
// keeps p == 0), l sums the f32 p, the p.v product uses p rounded to
// bf16, and the result is acc / (l == 0 ? 1 : l) — fully masked rows
// (left-pad queries) give 0, never NaN.
//
// What bounds it on this card: at game shapes (T ~ 2K suffix rows over
// S ~ 4-6K keys, Dh = 128) the two matrix products dominate, so it is
// bound by tensor-core operations.  The design keeps the TPU kernel's
// structure where it helps and replaces what was TPU-specific:
//   * one block per (q-tile of 64 rows, head, batch); the TPU's
//     sequential kv grid axis and its VMEM scratch (m, l, acc) become a
//     loop over 64-key tiles inside the block with m/l/acc in registers;
//   * q.k^T and p.v run on tensor cores through mma.sync m16n8k16 (bf16
//     in, f32 accumulate), four warps of 16 query rows each;
//   * the liveness skip (blk_any) is computed in the kernel from the
//     mask tile: a tile with no live (query, key) pair loads no K/V and
//     does no math;
//   * K/V are read straight from the KV-cache layout [B, S, Hkv, Dh]
//     through its batch and sequence strides, with 16-byte loads — no
//     transposed copy.
// This is the simple, correct first version: no TMA, no wgmma, no
// software pipelining of the K/V loads.  Head dim 128 only.

#include "common.cuh"

namespace {

constexpr int kBM = 64;              // query rows per block (16 per warp)
constexpr int kBN = 64;              // keys per tile
constexpr int kDh = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kDh + 8;     // smem row stride (bf16), padded vs bank conflicts
constexpr size_t kSmemBytes =
    (size_t)(kBM + 2 * kBN) * kStride * sizeof(__nv_bfloat16) + (size_t)kBM * kBN;

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,    // [B, T, H, Dh]
                     const __nv_bfloat16* __restrict__ k,    // [B, S, Hkv, Dh] strided
                     const __nv_bfloat16* __restrict__ v,
                     const uint8_t* __restrict__ mask,       // [B, T, S]
                     __nv_bfloat16* __restrict__ out,        // [B, T, H, Dh]
                     int T, int S, int H, int Hkv,
                     long long kv_bstride, long long kv_sstride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kBM * kStride;
  __nv_bfloat16* Vs = Ks + kBN * kStride;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + kBN * kStride);   // [kBM][kBN]

  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair
  const int wr = warp * 16;                 // this warp's first row in the tile

  // Q tile -> shared memory (zeros past T).
  for (int c = tid; c < kBM * (kDh / 8); c += kThreads) {
    const int r = c / (kDh / 8), col = (c % (kDh / 8)) * 8;
    const int t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(q + (((long long)b * T + t) * H + h) * kDh + col);
    }
    *reinterpret_cast<uint4*>(Qs + r * kStride + col) = val;
  }
  __syncthreads();

  // This warp's Q rows as mma A fragments, kept in registers.
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + g) * kStride + kk * 16 + t4 * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }

  float o[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {bcg::kNegInf, bcg::kNegInf};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  const long long mask_row0 = ((long long)b * T) * S;
  for (int s0 = 0; s0 < S; s0 += kBN) {
    __syncthreads();   // the previous tile's K/V/mask are no longer read
    int live = 0;
    for (int c = tid; c < kBM * kBN; c += kThreads) {
      const int r = c / kBN, col = c % kBN;
      const int t = q0 + r, s = s0 + col;
      const uint8_t mv = (t < T && s < S) ? mask[mask_row0 + (long long)t * S + s] : 0;
      Ms[c] = mv;
      live |= mv;
    }
    // Liveness skip: a tile with no live pair changes no m / l / acc.
    if (!__syncthreads_or(live)) continue;

    for (int c = tid; c < kBN * (kDh / 8); c += kThreads) {
      const int r = c / (kDh / 8), col = (c % (kDh / 8)) * 8;
      const int s = s0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (s < S) {
        const long long off = (long long)b * kv_bstride + (long long)s * kv_sstride
                              + (long long)hk * kDh + col;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(Ks + r * kStride + col) = kv;
      *reinterpret_cast<uint4*>(Vs + r * kStride + col) = vv;
    }
    __syncthreads();

    // scores = q . k^T for the warp's 16 rows x 64 keys.
    float sc[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * kStride + kk * 16 + t4 * 2;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(kb);
        bf[1] = *reinterpret_cast<const uint32_t*>(kb + 8);
        mma_16816(sc[j], qa[kk], bf);
      }
    }

    // Scale, mask, running max (element e: row g + 8*(e>=2), col 8j + 2*t4 + (e&1)).
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + ((e >> 1) << 3);
        const int col = j * 8 + t4 * 2 + (e & 1);
        const float val = Ms[r * kBN + col] ? sc[j][e] * scale : bcg::kNegInf;
        sc[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) alpha[i] = expf(m_run[i] - mx[i]);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = wr + g + ((e >> 1) << 3);
        const int col = j * 8 + t4 * 2 + (e & 1);
        const float p = expf(sc[j][e] - mx[e >> 1]) * (Ms[r * kBN + col] ? 1.f : 0.f);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_run[i] = alpha[i] * l_run[i] + rs[i];
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // acc += p(bf16) . v: the score accumulators of n-tiles 2kk, 2kk+1
    // are exactly the A fragment of key chunk kk.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = bcg::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = bcg::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = bcg::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = bcg::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const unsigned short* vb =
          reinterpret_cast<const unsigned short*>(Vs) + (kk * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        uint32_t bf[2];
        bf[0] = (uint32_t)vb[n * 8] | ((uint32_t)vb[n * 8 + kStride] << 16);
        bf[1] = (uint32_t)vb[n * 8 + 8 * kStride] | ((uint32_t)vb[n * 8 + 9 * kStride] << 16);
        mma_16816(o[n], pa, bf);
      }
    }
  }

  // out = acc / (l == 0 ? 1 : l), rows past T dropped.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = q0 + wr + g + 8 * i;
    if (t >= T) continue;
    const float l = l_run[i] == 0.f ? 1.f : l_run[i];
    __nv_bfloat16* orow = out + (((long long)b * T + t) * H + h) * kDh + t4 * 2;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          bcg::pack_bf16x2(o[n][2 * i] / l, o[n][2 * i + 1] / l);
    }
  }
}

}  // namespace

extern "C" int bcg_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* mask, void* out, int B, int T, int S,
                                 int H, int Hkv, long long kv_bstride,
                                 long long kv_sstride, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + kBM - 1) / kBM, H, B);
  flash_prefill_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), T, S, H, Hkv, kv_bstride, kv_sstride, scale);
  return (int)cudaGetLastError();
}
