// W4A16 matrix product for Hopper (sm_90a): out = x @ dequant(q4, gscale).
//
// Replaces: bcg_tpu/ops/w4_matmul.py::_w4_kernel (pallas_call :116 in
// _w4a16_2d :107, wrapper w4a16_matmul :150).
//
// Computes, for x bf16 [M, D] (D = 2P, M up to 256), the packed int4
// weight q4 int8 [P, F] and its bf16 group scales gscale [2 * ng, F]
// (group g = P / ng rows; the top half's groups first):
//   out[m, f] = sum_i x[m, i]     * bf16(lo(q4[i, f]) * gscale[i / g, f])
//             + sum_i x[m, P + i] * bf16(hi(q4[i, f]) * gscale[ng + i / g, f])
// in f32, as the TPU kernel does: each byte's low nibble is sign-extended
// by shifts, its high nibble by an arithmetic shift, each value times its
// group's scale in f32 is rounded to bf16 before the product, and the
// products of bf16 operands accumulate in f32.  The packing runs along
// the contraction axis, so the low nibbles meet x[:, :P] and the high
// ones x[:, P:] and nothing is interleaved.
//
// What bounds it on this card: at the decode shapes (M = 10, or 40-50 for
// a chunk) the packed weight is read once for 2 * M * D * F operations,
// 4M operations per byte of q4 — under the ~295 the tensor cores need, so
// it is bound by memory bytes.  The design streams q4 once, 16-byte
// cp.async loads along F (q4 is row-major [P, F]) into a 4-stage ring of
// shared memory, and dequantizes in registers straight into the B
// fragments of mma.sync m16n8k16 (bf16 in, f32 accumulate), the x rows
// padded to 16 per m-tile.  Each block owns 128 output columns (4 warps
// of 32) and up to 64 rows; where that leaves fewer than two blocks per
// SM (wk/wv at F = 1024 give 8 column blocks), the contraction is split
// across blocks, each writing its partial sums to a scratch buffer that a
// second kernel adds up in a fixed order (no atomics: the result does not
// change from run to run).  Group sizes are multiples of 32, the rows of
// one stage, so a stage reads one scale row per half.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;            // 4 warps
constexpr int kBN = 128;                 // output columns per block, 32 per warp
constexpr int kKT = 32;                  // packed rows per stage (the smallest group)
constexpr int kStages = 4;
constexpr int kQStride = kBN + 16;       // bytes per staged q4 row (padded vs bank conflicts)
constexpr int kXStride = 2 * kKT + 8;    // bf16 per staged x row: 32 low + 32 high columns

template <int MT>
struct Smem {
  int8_t q[kStages][kKT][kQStride];
  __nv_bfloat16 x[kStages][MT * 16][kXStride];
  __nv_bfloat16 s[kStages][2][kBN];
};

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, or 16 zero bytes where `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

__device__ __forceinline__ float lo_nibble(int v) {
  return (float)((int)((unsigned)v << 28) >> 28);
}
__device__ __forceinline__ float hi_nibble(int v) { return (float)(v >> 4); }

// One block: columns [n0, n0 + 128), rows [m0, m0 + 16 MT), packed rows
// of k-steps [kt0, kt1).  `out` is [M, F], or this split's slice of the
// [splits, M, F] scratch when the contraction is split.
template <int MT>
__global__ void __launch_bounds__(kThreads)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,    // [M, 2P]
             const int8_t* __restrict__ q4,          // [P, F]
             const __nv_bfloat16* __restrict__ gs,   // [2 * ng, F]
             float* __restrict__ out,
             int M, int P, int F, int group, int kt_per_split) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<MT>& sm = *reinterpret_cast<Smem<MT>*>(smem_raw);
  const int n0 = blockIdx.x * kBN;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * MT * 16;
  const int kt0 = split * kt_per_split;
  const int steps = min(P / kKT, kt0 + kt_per_split) - kt0;
  const int ng = P / group;
  const int D = 2 * P;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;     // mma fragment row group / column pair

  auto load_stage = [&](int st, int kt) {
    const int i0 = kt * kKT;
    for (int c = tid; c < kKT * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), col = (c % (kBN / 16)) * 16;
      const bool ok = n0 + col < F;
      cp_async16(&sm.q[st][r][col], ok ? q4 + (long long)(i0 + r) * F + n0 + col : q4, ok);
    }
    for (int c = tid; c < MT * 16 * 8; c += kThreads) {
      const int r = c >> 3, half = (c >> 2) & 1, col = (c & 3) * 8;
      const bool ok = m0 + r < M;
      cp_async16(&sm.x[st][r][half * kKT + col],
                 ok ? x + (long long)(m0 + r) * D + half * P + i0 + col : x, ok);
    }
    if (tid < 2 * (kBN / 8)) {
      const int half = tid / (kBN / 8), col = (tid % (kBN / 8)) * 8;
      const int row = i0 / group + half * ng;
      const bool ok = n0 + col < F;
      cp_async16(&sm.s[st][half][col], ok ? gs + (long long)row * F + n0 + col : gs, ok);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, kt0 + s);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage t has landed; stage t - 1 is free to refill
    if (t + kStages - 1 < steps) load_stage((t + kStages - 1) % kStages, kt0 + t + kStages - 1);
    cp_async_commit();
    const int st = t % kStages;

    float s_lo[4], s_hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = warp * 32 + j * 8 + gid;
      s_lo[j] = __bfloat162float(sm.s[st][0][n]);
      s_hi[j] = __bfloat162float(sm.s[st][1][n]);
    }
#pragma unroll
    for (int kk = 0; kk < kKT; kk += 16) {
      // B fragments (k = packed rows kk + 2 tig + {0, 1, 8, 9}, n = gid of
      // each n-tile), the low and the high nibble of the same bytes.
      uint32_t b_lo[4][2], b_hi[4][2];
      const int r = kk + tig * 2;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp * 32 + j * 8 + gid;
        const int v0 = sm.q[st][r][n], v1 = sm.q[st][r + 1][n];
        const int v8 = sm.q[st][r + 8][n], v9 = sm.q[st][r + 9][n];
        b_lo[j][0] = bcg::pack_bf16x2(lo_nibble(v0) * s_lo[j], lo_nibble(v1) * s_lo[j]);
        b_lo[j][1] = bcg::pack_bf16x2(lo_nibble(v8) * s_lo[j], lo_nibble(v9) * s_lo[j]);
        b_hi[j][0] = bcg::pack_bf16x2(hi_nibble(v0) * s_hi[j], hi_nibble(v1) * s_hi[j]);
        b_hi[j][1] = bcg::pack_bf16x2(hi_nibble(v8) * s_hi[j], hi_nibble(v9) * s_hi[j]);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* x0 = &sm.x[st][mt * 16 + gid][kk + tig * 2];
        const __nv_bfloat16* x8 = &sm.x[st][mt * 16 + gid + 8][kk + tig * 2];
        uint32_t a_lo[4], a_hi[4];
        a_lo[0] = *reinterpret_cast<const uint32_t*>(x0);
        a_lo[1] = *reinterpret_cast<const uint32_t*>(x8);
        a_lo[2] = *reinterpret_cast<const uint32_t*>(x0 + 8);
        a_lo[3] = *reinterpret_cast<const uint32_t*>(x8 + 8);
        a_hi[0] = *reinterpret_cast<const uint32_t*>(x0 + kKT);
        a_hi[1] = *reinterpret_cast<const uint32_t*>(x8 + kKT);
        a_hi[2] = *reinterpret_cast<const uint32_t*>(x0 + kKT + 8);
        a_hi[3] = *reinterpret_cast<const uint32_t*>(x8 + kKT + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_16816(acc[mt][j], a_lo, b_lo[j]);
          mma_16816(acc[mt][j], a_hi, b_hi[j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float* dst = out + (long long)split * M * F;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + warp * 32 + j * 8 + tig * 2;
      if (col >= F) continue;
      const int row = m0 + mt * 16 + gid;
      if (row < M)
        *reinterpret_cast<float2*>(dst + (long long)row * F + col) =
            make_float2(acc[mt][j][0], acc[mt][j][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(dst + (long long)(row + 8) * F + col) =
            make_float2(acc[mt][j][2], acc[mt][j][3]);
    }
  }
}

// out[i] = sum over splits s, in order, of ws[s][i] (n4 = M * F / 4 float4s).
__global__ void w4a16_reduce_kernel(const float4* __restrict__ ws, float4* __restrict__ out,
                                    int splits, long long n4) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    float4 s = ws[i];
    for (int k = 1; k < splits; ++k) {
      const float4 v = ws[k * n4 + i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    out[i] = s;
  }
}

template <int MT>
int launch(const void* x, const void* q4, const void* gs, float* dst, int M, int P, int F,
           int group, int splits, int kt_per_split, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem<MT>);
  static bool smem_set = false;   // once per instance (the attribute persists)
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a16_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  dim3 grid((F + kBN - 1) / kBN, splits, (M + MT * 16 - 1) / (MT * 16));
  w4a16_kernel<MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q4),
      static_cast<const __nv_bfloat16*>(gs), dst, M, P, F, group, kt_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, 2P], q4 int8 [P, F], gscale bf16 [2P / group, F], out f32
// [M, F]; ws f32 [splits, M, F] when splits > 1 (else unused).  `mt` is
// the m-tiles of 16 rows per block: 1, 2 or 4.  Requires group % 32 == 0,
// P % group == 0 and F % 16 == 0 (the wrapper checks).
extern "C" int bcg_w4a16(const void* x, const void* q4, const void* gscale, void* out,
                         void* ws, int M, int P, int F, int group, int splits,
                         int kt_per_split, int mt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* dst = static_cast<float*>(splits > 1 ? ws : out);
  int err;
  if (mt == 1) err = launch<1>(x, q4, gscale, dst, M, P, F, group, splits, kt_per_split, s);
  else if (mt == 2) err = launch<2>(x, q4, gscale, dst, M, P, F, group, splits, kt_per_split, s);
  else if (mt == 4) err = launch<4>(x, q4, gscale, dst, M, P, F, group, splits, kt_per_split, s);
  else return (int)cudaErrorInvalidValue;
  if (err != 0 || splits == 1) return err;
  const long long n4 = (long long)M * F / 4;
  const int blocks = (int)((n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024);
  w4a16_reduce_kernel<<<blocks, 256, 0, s>>>(static_cast<const float4*>(ws),
                                             static_cast<float4*>(out), splits, n4);
  return (int)cudaGetLastError();
}
