// W4A16 matrix product for Hopper (sm_90a): out = x @ dequant(q4, gscale).
//
// Replaces: bcg_tpu/ops/w4_matmul.py::_w4_kernel (pallas_call :116 in
// _w4a16_2d :107, wrapper w4a16_matmul :150).
//
// Computes, for x bf16 [M, D] (D = 2P, M up to 256), the packed int4
// weight q4 [P, F] (byte [i, f] holds row i in its low nibble and row
// P + i in its high one) and its bf16 group scales gscale [2 * ng, F]
// (group g = P / ng rows; the top half's groups first):
//   out[m, f] = sum_i x[m, i]     * bf16(lo(q4[i, f]) * gscale[i / g, f])
//             + sum_i x[m, P + i] * bf16(hi(q4[i, f]) * gscale[ng + i / g, f])
// in f32, as the TPU kernel does: each nibble is a signed integer in
// [-8, 7], its product with its group's scale is rounded to bf16 before
// the product with x, and the products of bf16 operands accumulate in
// f32.  q4 is stored output-major: the bytes of column f are the P
// contiguous bytes at f * P (the transpose of a contiguous [F, P]).
//
// What bounds it on this card: at the decode shapes (M = 10 on the
// plain loop, 40-50 for a chunk) the packed weight is read once for
// 2 * M * D * F operations, 4M operations per byte of q4 -- far under the
// ~295 the tensor cores need, so it is bound by memory bytes, and by the
// instructions it spends per byte on the way to the tensor cores.  The
// design:
//
// * One launch, 512 threads a block, one block an SM.  A block streams
//   its tiles of 16 * wc output columns (wc column warps; the 16 / wc
//   warps of each column share its packed rows, "k-groups") over its
//   split of the contraction; where there are more tiles than blocks the
//   block walks them in turn, its x staying in shared memory.  Where a
//   split leaves the contraction to several blocks, each writes its f32
//   partial to a workspace owned by the wrapper and the last block of
//   each tile to arrive (an arrival counter, left at 0 again) adds the
//   partials in split order: deterministic and graph-capturable, no
//   second kernel.
// * Wide loads in the order the products take them.  Each thread copies
//   16 bytes of one column (16 packed rows) and 16 of the column 8 to the
//   right, with 16-byte cp.async into a four-stage ring of its own shared
//   memory (no barrier: a thread reads only what it copied), along with
//   the four scale pairs those bytes need; a block keeps three stages,
//   ~72 KB, in flight.  Each 32-bit word of those bytes is one k-step of
//   an mma.sync m16n8k16 whose A operand is the dequantized weight
//   (output columns as rows, so 1-8 x rows waste no m16 tile) and whose B
//   operand is x: k-slots (2t, 2t + 1, 2t + 8, 2t + 9) of thread t take
//   bytes (0, 1, 2, 3) of its word, so each B fragment is one 8-byte
//   shared load of x as stored.  x is copied once per block by cp.async,
//   ahead of the weights, so that its round trips to L2 overlap theirs.
// * No integer-to-float conversion and no f32 multiply.  A nibble n
//   (XOR 8) placed by lop3 in the mantissa of bf16 128 reads 128 + (n ^ 8)
//   exactly; one bf16x2 subtraction of 136 leaves the signed value, and
//   one bf16x2 multiply by the group scale rounds the exact 12-bit product
//   once: bit-identical to bf16(float(q) * float(scale)).  Eight values
//   cost two byte permutes, two shifts, four lop3, four subtractions and
//   four multiplies.
//
// What still bounds it (throwaway variants timed like tools/w4_kernels.py
// on an H100): the copies.  Without its arithmetic the kernel reads the
// LM head only a few per cent faster; without its copies it computes
// well under the bound; plain 16-byte loads into registers in the same
// order read near the card's rate, but with the arithmetic interleaved,
// two or three steps of them in flight a warp, they lost at ten rows.
// Overlapping plain loads with the arithmetic (producer warps, or more
// warps an SM) is the next step.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;            // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // packed rows of one warp step (16 per thread)
constexpr int kStages = 4;
constexpr int kRedStride = 20;           // floats per staged accumulator row (16 columns, padded)

// One stage of the per-thread ring: 16 bytes of columns gid and gid + 8,
// and the 4-byte words holding their low-half and high-half scales.
struct Stage {
  uint4 w[2][kThreads];
  uint32_t s[4][kThreads];
};

constexpr size_t kRingBytes = kStages * sizeof(Stage);
// The accumulators the warps past a column's first k-group stage for it.
__host__ __device__ constexpr size_t red_bytes(int nt, int wc) {
  return (size_t)(kWarps - wc) * 8 * nt * kRedStride * sizeof(float);
}
// x rows [rows][2 * kb + 4] bf16: a split's low and high halves, padded so
// that the fragment loads of a half-warp hit 32 distinct banks (rows are
// 8-byte aligned, so x is copied 8 bytes at a time).
__host__ __device__ constexpr size_t x_bytes(int rows, int kb) {
  return (size_t)rows * (2 * kb + 4) * sizeof(__nv_bfloat16);
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// `bytes` (16 or 4) global -> shared, or zeros where `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Two nibbles (bits 0-3 and 16-19 of `u`) times the bf16x2 scale `s2`:
// (n ^ 8) in the mantissa of 128 (lop3: (u & 0x000F000F) ^ 0x43084308),
// minus 136, times the scale -- each step exact but the last, which
// rounds once.
__device__ __forceinline__ uint32_t dequant2(uint32_t u, uint32_t s2) {
  uint32_t t;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(t) : "r"(u), "r"(0x000F000Fu), "r"(0x43084308u));
  __nv_bfloat162 v = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&t),
                             __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                __ushort_as_bfloat16(0x4308)));
  v = __hmul2(v, *reinterpret_cast<__nv_bfloat162*>(&s2));
  return *reinterpret_cast<uint32_t*>(&v);
}

// One block: row block blockIdx.z (8 NT rows), contraction split
// blockIdx.y (packed rows [z * kb, z * kb + kb)), output column tiles
// blockIdx.x, + gridDim.x, ... of 16 * wc columns.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
w4a16_kernel(const __nv_bfloat16* __restrict__ x,    // [M, 2P]
             const uint8_t* __restrict__ q4,         // column f at f * P
             const __nv_bfloat16* __restrict__ gs,   // [2 * ng, F]
             float* __restrict__ out,                // [M, F]
             float* __restrict__ part,               // [splits, M, F] when split
             unsigned* __restrict__ count,           // [row blocks, tiles] when split
             int M, int P, int F, int ng, unsigned gmagic, int gshift, int kb, int wc) {
  constexpr int R = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* ring = reinterpret_cast<Stage*>(smem);
  float* red = reinterpret_cast<float*>(smem + kRingBytes);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + kRingBytes + red_bytes(NT, wc));
  __shared__ unsigned is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;     // mma fragment row group / column pair
  const int wk = kWarps / wc;                    // warps sharing a column's packed rows
  const int wcol = warp % wc, kg = warp / wc;
  const int bn = 16 * wc;
  const int n_tiles = (F + bn - 1) / bn;
  const int splits = gridDim.y, z = blockIdx.y;
  const int row0 = blockIdx.z * R, rows = min(R, M - row0);
  const int k0 = z * kb, klen = min(P - k0, kb);
  const int nchunk = (klen + kChunk - 1) / kChunk;
  const int cnt = nchunk > kg ? (nchunk - kg + wk - 1) / wk : 0;   // this warp's chunks a tile
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const int steps = my_tiles * cnt;
  const int xstride = 2 * kb + 4;

  // The copies of this warp's next step (its chunk is_j of the block's
  // tile is_t) into ring stage is_n % kStages; one commit group a call,
  // empty ones past the last step keep the count.
  int is_n = 0, is_t = 0, is_j = 0;
  auto issue = [&]() {
    if (is_n < steps) {
      Stage& st = ring[is_n & (kStages - 1)];
      const int tile = blockIdx.x + is_t * gridDim.x;
      const int kloc = (kg + is_j * wk) * kChunk + 16 * tig;
      const int col = tile * bn + wcol * 16 + gid;
      const bool ok = col < F && kloc < klen;    // F % 16 == 0: the 16 columns are in or out
      const int kabs = k0 + kloc;
      const uint8_t* src = q4 + (long long)col * P + kabs;
      cp_async16(&st.w[0][tid], ok ? src : q4, ok);
      cp_async16(&st.w[1][tid], ok ? src + 8LL * P : q4, ok);
      // kabs / group by a multiply (the wrapper's magic); a 16-row run lies
      // in one group.
      const int grp = ok ? (int)((__umulhi((unsigned)kabs, gmagic) + (unsigned)kabs) >> gshift) : 0;
      const __nv_bfloat16* slo = gs + (long long)grp * F + (col & ~1);
      const __nv_bfloat16* shi = slo + (long long)ng * F;
      cp_async4(&st.s[0][tid], ok ? slo : gs, ok);
      cp_async4(&st.s[1][tid], ok ? slo + 8 : gs, ok);
      cp_async4(&st.s[2][tid], ok ? shi : gs, ok);
      cp_async4(&st.s[3][tid], ok ? shi + 8 : gs, ok);
      if (++is_j == cnt) {
        is_j = 0;
        ++is_t;
      }
    }
    cp_async_commit();
    ++is_n;
  };

  // x rows [row0, row0 + rows), packed rows [k0, k0 + klen) of each half,
  // copied by cp.async ahead of the weights (the oldest commit group);
  // zeros up to the last whole chunk (whose weight bytes are zero too).
  {
    const int kpad = nchunk * kChunk;
    const int per_half = kpad / 4, per_row = 2 * per_half;
    for (int i = tid; i < rows * per_row; i += kThreads) {
      const int m = i / per_row, j = i % per_row;
      const int h = j / per_half, e = (j % per_half) * 4;
      const bool ok = e < klen;
      cp_async8(xs + m * xstride + h * kb + e,
                ok ? x + (long long)(row0 + m) * 2 * P + h * P + k0 + e : x, ok);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue();
  cp_async_wait<kStages - 1>();   // x (every thread's share) has landed; the weights fly on
  __syncthreads();

  // Columns gid and gid + 8 of a tile share their parity (tiles start even).
  const uint32_t sel = (gid & 1) ? 0x3232u : 0x1010u;
  int s = 0;
  for (int t = 0; t < my_tiles; ++t) {
    const int tile = blockIdx.x + t * gridDim.x;
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int j = 0; j < cnt; ++j, ++s) {
      cp_async_wait<kStages - 2>();              // step s has landed (this thread's copies)
      issue();                                   // step s + 3, into the stage step s - 1 used
      const Stage& st = ring[s & (kStages - 1)];
      const uint4 wa = st.w[0][tid], wb = st.w[1][tid];
      const uint32_t sal = __byte_perm(st.s[0][tid], 0u, sel);
      const uint32_t sbl = __byte_perm(st.s[1][tid], 0u, sel);
      const uint32_t sah = __byte_perm(st.s[2][tid], 0u, sel);
      const uint32_t sbh = __byte_perm(st.s[3][tid], 0u, sel);
      const __nv_bfloat16* xr = xs + (kg + j * wk) * kChunk + 16 * tig;
      const uint32_t wav[4] = {wa.x, wa.y, wa.z, wa.w};
      const uint32_t wbv[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        // A fragments: rows gid (column a) and gid + 8 (column b); k-slots
        // 2t, 2t + 1 <- bytes 0, 1 and 2t + 8, 2t + 9 <- bytes 2, 3 (each
        // pair moved to the two halves of a word by a byte permute).
        const uint32_t a01 = __byte_perm(wav[w], 0u, 0x4140), a23 = __byte_perm(wav[w], 0u, 0x4342);
        const uint32_t b01 = __byte_perm(wbv[w], 0u, 0x4140), b23 = __byte_perm(wbv[w], 0u, 0x4342);
        const uint32_t alo[4] = {dequant2(a01, sal), dequant2(b01, sbl), dequant2(a23, sal),
                                 dequant2(b23, sbl)};
        const uint32_t ahi[4] = {dequant2(a01 >> 4, sah), dequant2(b01 >> 4, sbh),
                                 dequant2(a23 >> 4, sah), dequant2(b23 >> 4, sbh)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int m = n * 8 + gid;
          uint2 bl = make_uint2(0u, 0u), bh = make_uint2(0u, 0u);
          if (m < rows) {
            const __nv_bfloat16* p = xr + m * xstride + 4 * w;
            bl = *reinterpret_cast<const uint2*>(p);
            bh = *reinterpret_cast<const uint2*>(p + kb);
          }
          mma_16816(acc[n], alo, bl.x, bl.y);
          mma_16816(acc[n], ahi, bh.x, bh.y);
        }
      }
    }

    // The tile's sums: the warps of k-groups 1.. stage their accumulators
    // (column gid / gid + 8, rows 2t, 2t + 1 of each n-tile), and each
    // column's first warp adds them in k-group order and stores the tile.
    const auto at = [&](int g, int n, int e) {   // k-group g's staged element e of n-tile n
      const int m = n * 8 + 2 * tig + (e & 1), c = gid + 8 * (e >> 1);
      return red + (((g - 1) * wc + wcol) * R + m) * kRedStride + c;
    };
    if (kg > 0) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) *at(kg, n, e) = acc[n][e];
    }
    __syncthreads();
    const int c0 = tile * bn;
    if (kg == 0) {
      float* dst = splits == 1 ? out : part + (long long)z * M * F;
      const int ca = c0 + wcol * 16 + gid;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = acc[n][e];
          for (int g = 1; g < wk; ++g) v += *at(g, n, e);
          const int m = n * 8 + 2 * tig + (e & 1);
          if (m < rows && ca < F) dst[(long long)(row0 + m) * F + ca + 8 * (e >> 1)] = v;
        }
      }
    }
    if (splits > 1) {
      // The last split of this tile to arrive adds the partials in split
      // order and leaves the counter at 0.
      __threadfence();
      __syncthreads();
      unsigned* cnt_tile = count + (long long)blockIdx.z * n_tiles + tile;
      if (tid == 0) is_last = atomicAdd(cnt_tile, 1u) == (unsigned)(splits - 1);
      __syncthreads();
      if (is_last) {
        __threadfence();
        for (int i = tid; i < rows * bn; i += kThreads) {
          const int m = i / bn, c = i % bn;
          if (c0 + c >= F) continue;
          const long long o = (long long)(row0 + m) * F + c0 + c;
          float v = 0.f;
          for (int zz = 0; zz < splits; ++zz) v += __ldcg(part + (long long)zz * M * F + o);
          out[o] = v;
        }
        if (tid == 0) *cnt_tile = 0u;
      }
    }
    __syncthreads();   // the staged accumulators and is_last are reused by the next tile
  }
  cp_async_wait<0>();
}

template <int NT>
int launch(const void* x, const void* q4, const void* gs, void* out, void* part, void* count,
           int M, int P, int F, int ng, unsigned gmagic, int gshift, int wc, int splits, int kb,
           int gx, cudaStream_t stream) {
  const size_t smem = kRingBytes + red_bytes(NT, wc) + x_bytes(min(M, 8 * NT), kb);
  static size_t smem_set = 0;   // the attribute persists; raised when a launch needs more
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        w4a16_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  dim3 grid(gx, splits, (M + 8 * NT - 1) / (8 * NT));
  w4a16_kernel<NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const __nv_bfloat16*>(gs), static_cast<float*>(out),
      static_cast<float*>(part), static_cast<unsigned*>(count), M, P, F, ng, gmagic, gshift, kb,
      wc);
  return (int)cudaGetLastError();
}

}  // namespace

// x bf16 [M, 2P]; q4 [P, F] output-major (column f at byte f * P); gscale
// bf16 [2 * ng, F] (groups of P / ng rows, a multiple of 32); out f32
// [M, F].  A packed row's group is (umulhi(r, gmagic) + r) >> gshift (the
// wrapper's exact division by the group size).  The plan (ops/w4_matmul.py
// split_plan): nt n-tiles of 8 rows a row block (1, 2, 4 or 8), wc column
// warps (1, 2, 4, 8 or 16), `splits` contraction splits of kb packed rows
// (a multiple of 64), gx blocks along the columns.  splits > 1: part holds
// splits * M * F floats and count (row blocks * tiles) unsigned ints, all
// 0 (the kernel leaves them 0 again).  F % 16 == 0 (the wrapper checks).
extern "C" int bcg_w4a16(const void* x, const void* q4, const void* gscale, void* out,
                         void* part, void* count, int M, int P, int F, int ng,
                         unsigned gmagic, int gshift, int nt, int wc, int splits, int kb,
                         int gx, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define BCG_W4_LAUNCH(NT) \
  launch<NT>(x, q4, gscale, out, part, count, M, P, F, ng, gmagic, gshift, wc, splits, kb, gx, s)
  switch (nt) {
    case 1: return BCG_W4_LAUNCH(1);
    case 2: return BCG_W4_LAUNCH(2);
    case 4: return BCG_W4_LAUNCH(4);
    case 8: return BCG_W4_LAUNCH(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BCG_W4_LAUNCH
}
