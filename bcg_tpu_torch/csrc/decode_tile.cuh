// Shared body of the decode-attention kernels (sm_90a): the bf16 single
// step (B3a), the bf16 chunk, the int8 and the paged kernels.
//
// One block per (kv head hk, batch row b, split z) computes, for the
// R = Kq * G query rows of that kv head (Kq chunk positions times the GQA
// group G = H / Hkv, position-major: row r is chunk position r / G, query
// head hk * G + r % G):
//   out[r] = sum_s softmax_s(scale * q[r].k[s], mask[mrow(r)][s]) * v[s]
// over the cache window, where the mask has Mk rows per batch row and
// row r reads mask row 0 (Mk == 1) or r / mask_div (mask_div = G for the
// chunk forms' [B, Kq, S] mask, 1 for B3a's per-query-row [B, G, S]
// mask).  The arithmetic is the Pallas decode kernels': masked scores
// take the -1e30 sentinel, p = exp(s - m) * mask (a fully masked row
// gives 0), l sums the f32 p, the p.v product takes p rounded to bf16,
// and out = acc / (l == 0 ? 1 : l).
//
// Layout and addressing are two template policies.  KVChunk<kLayout>
// reads one 16-byte slice of a position's row and writes it to shared
// memory as bf16: bf16 as stored; int8 dequantized with its f32 scale;
// packed int4 unpacked into two column runs and dequantized with its
// bf16 scale (each value float(v) * scale rounded to bf16, as the TPU
// kernels do, before either product).  Addr maps a position to its
// storage offset: DenseAddr for the dense caches (bf16 [B, S, Hkv, Dh],
// int8 [B, Hkv, S, Dh] with scales [B, Hkv, S]); PagedAddr for a block
// pool read through the batch row's block table (bf16 [N, bs, Hkv, Dh],
// int8 [N, Hkv, bs, Dh] and int4 [N, Hkv, bs, Dh/2] with scales
// [N, Hkv, bs]).
//
// Design.  Four warps; the R rows are cut into nM = ceil(R / 16) m-tiles
// of the mma.sync m16n8k16 shape (bf16 in, f32 accumulate), so 16-20
// rows never sit in per-thread arrays sized by R: each warp holds one
// 16-row tile (q as A fragments, 32 registers; acc 16 x 128 f32, 64
// registers).  The 4 / nM warps that share an m-tile split the positions
// of each block iteration between them (32 positions a warp), each with
// its own online-softmax state, and the splits are merged once at the
// end through shared memory.  Every iteration stages 32 * (4 / nM)
// positions of K and V (dequantized to bf16 for a quantized cache) and
// the mask rows in shared memory; an iteration with no live (row,
// position) pair loads no K/V.  A bf16 cache at one m-tile (R <= 16) is
// loaded an iteration at a time, each thread keeping 4 + 4 16-byte loads
// in flight before storing any; at two m-tiles or more an iteration holds
// 64 positions or fewer, so the K/V space sized for 128 holds two stages
// and the next iteration's rows are copied by cp.async while this one is
// computed (the bf16 ring, compiled in by the kRing option).  A quantized
// cache is pipelined: the raw rows of the next iteration are copied by
// cp.async into a staging buffer (raw_bytes) while this one is
// dequantized and computed.  Both
// pipelined loops load the mask an iteration further ahead into
// registers, so that a dead iteration is never copied (a mask taller
// than kMaskRegs bytes a thread takes the loop that loads an iteration
// at a time).  Shared memory is sized for the rows a launch has
// (launch_smem): 74 KB at R <= 16 for bf16, so three blocks fit on an SM;
// 108 KB with the int8 staging and 91 KB with the int4 one, two.
//
// Split-S (flash-decoding), the SplitS option.  One block per (b, hk)
// leaves B * Hkv blocks (80 at the bench-8b game shape) on 132 SMs, each
// streaming the whole window alone: the kernel is then bound by one
// block's load latency, not by the card's bytes.  With split.len > 0 the
// grid's third axis cuts the window into gridDim.z contiguous ranges of
// split.len positions (a multiple of kSuper, and of the block size for a
// paged pool; the last range takes the rest of S: split_range).  Each
// block writes its rows' f32 partials (the unnormalised acc, the running
// max m and the sum l over unrounded p) to split.part; the last block of
// a (b, hk) to arrive — __threadfence, then an atomicAdd on
// split.count[b * Hkv + hk] — merges the splits in split order (so the
// result does not depend on arrival order: repeated calls are
// bit-identical), normalises, writes bf16 and sets the count back to 0.
// The merge is the JAX package's flash-decoding merge
// (bcg_tpu/ops/ring_attention.py sp_chunk_decode_attention): global max,
// each split weighted by exp(m_z - m), out = acc / l; a split with no
// live position (l_z == 0) weighs exactly 0, never exp(-1e30 - -1e30).
// One launch, no second combine kernel, nothing allocated: the caller
// owns the workspace (ops/decode_attention.py), so a call can be
// captured in a CUDA graph.  Every launcher turns it on (each paged
// block stages only its split's range of the block table).
//
// Still missing: no TMA, and at one m-tile no overlap of one iteration's
// bf16 loads with the same block's math (other resident blocks cover
// it).  Head dim 128; R up to 64.
#pragma once

#include "common.cuh"

namespace bcg_tile {

constexpr int kDh = 128;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWN = 32;                       // positions per warp per iteration
constexpr int kSuper = kWarps * kWN;          // most positions per iteration
constexpr int kMaxRows = 64;                  // R = Kq * G
constexpr int kStride = kDh + 8;              // smem row stride (bf16), padded vs bank conflicts
// Dynamic shared memory for `rows` (a multiple of 16) query rows and
// `mask_rows` staged mask rows; kSmemBytes fits every launch.
__host__ __device__ constexpr size_t smem_bytes(int rows, int mask_rows) {
  return (size_t)(rows + 2 * kSuper) * kStride * sizeof(__nv_bfloat16) +
         (size_t)mask_rows * kSuper;
}
constexpr size_t kSmemBytes = smem_bytes(kMaxRows, kMaxRows);
// Bytes of one position's stored row: bf16, int8 or packed int4.
__host__ __device__ constexpr int row_bytes(int layout) {
  return layout == 0 ? kDh * 2 : layout == 1 ? kDh : kDh / 2;
}
// The quantized layouts' staging of one iteration's raw K and V rows and
// their scales (as f32), filled by cp.async while the previous iteration
// is computed; none for bf16.
__host__ __device__ constexpr size_t raw_bytes(int layout) {
  return layout == 0 ? 0 : (size_t)2 * kSuper * (row_bytes(layout) + sizeof(float));
}
// Shared memory of a launch with R query rows (a whole number of 16-row
// m-tiles), Mk mask rows and the cache's layout.
__host__ __device__ inline size_t launch_smem(int R, int Mk, int layout) {
  return smem_bytes((R + 15) / 16 * 16, Mk) + raw_bytes(layout);
}

__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
// The same, or 16 zero bytes where `pred` is false.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Storage layouts of the cache: bf16 values; int8 values with one f32
// scale per (position, kv head); packed int4 (byte j of a position's
// row holds element j in its low nibble and element j + Dh/2 in its
// high nibble) with one bf16 scale per (position, kv head).
enum Layout { kBf16 = 0, kInt8 = 1, kInt4 = 2 };

// Cache row chunks into shared memory as bf16, in two steps so that a
// batch of loads is in flight before any is used: load() reads 16 bytes
// of one position's row (and, quantized, its scale), store() writes them
// dequantized (float(v) * scale, rounded to bf16, as the TPU kernels do).
// kLoads is the number of 16-byte loads per position's row.
template <int kLayout>
struct KVChunk;

template <>
struct KVChunk<kBf16> {
  using Elem = __nv_bfloat16;
  using Scale = float;
  static constexpr int kLoads = kDh / 8;
  uint4 raw;
  __device__ __forceinline__ void clear() { raw = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void load(const Elem* row, const Scale*, int j) {
    raw = *reinterpret_cast<const uint4*>(row + j * 8);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* dst, int j) const {
    *reinterpret_cast<uint4*>(dst + j * 8) = raw;
  }
};

template <>
struct KVChunk<kInt8> {
  using Elem = int8_t;
  using Scale = float;
  static constexpr int kLoads = kDh / 16;
  uint4 raw;
  float sc;
  __device__ __forceinline__ void clear() {
    raw = make_uint4(0u, 0u, 0u, 0u);
    sc = 0.f;
  }
  __device__ __forceinline__ void load(const Elem* row, const Scale* scale, int j) {
    raw = *reinterpret_cast<const uint4*>(row + j * 16);
    sc = *scale;
  }
  // float(v) exactly without an int-to-float conversion (a quarter-rate
  // instruction): byte v ^ 0x80 = v + 128 placed in the low mantissa of
  // 2^23 reads 2^23 + v + 128, and the subtraction is exact.
  static __device__ __forceinline__ float byte_to_float(uint32_t word, int i) {
    return __uint_as_float(__byte_perm(word, 0x4B000000u, 0x7440u | i)) - 8388736.f;
  }
  __device__ __forceinline__ void store(__nv_bfloat16* dst, int j) const {
    const uint32_t* w32 = reinterpret_cast<const uint32_t*>(&raw);
    uint32_t out[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w32[i] ^ 0x80808080u;
      out[2 * i] = bcg::pack_bf16x2(byte_to_float(u, 0) * sc, byte_to_float(u, 1) * sc);
      out[2 * i + 1] = bcg::pack_bf16x2(byte_to_float(u, 2) * sc, byte_to_float(u, 3) * sc);
    }
    *reinterpret_cast<uint4*>(dst + j * 16) = make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(dst + j * 16 + 8) = make_uint4(out[4], out[5], out[6], out[7]);
  }
};

// Packed int4: a 16-byte load holds 32 values of two separate runs —
// elements [16j, 16j + 16) in the low nibbles and [Dh/2 + 16j,
// Dh/2 + 16j + 16) in the high nibbles — so one load feeds two 16-column
// runs of the shared-memory row.  Each nibble is sign-extended by an
// arithmetic shift; the bf16 scale is read as float.
template <>
struct KVChunk<kInt4> {
  using Elem = int8_t;
  using Scale = __nv_bfloat16;
  static constexpr int kLoads = kDh / 32;
  uint4 raw;
  float sc;
  __device__ __forceinline__ void clear() {
    raw = make_uint4(0u, 0u, 0u, 0u);
    sc = 0.f;
  }
  __device__ __forceinline__ void load(const Elem* row, const Scale* scale, int j) {
    raw = *reinterpret_cast<const uint4*>(row + j * 16);
    sc = __bfloat162float(*scale);
  }
  __device__ __forceinline__ void store(__nv_bfloat16* dst, int j) const {
    const uint8_t* b8 = reinterpret_cast<const uint8_t*>(&raw);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int8_t b0 = (int8_t)b8[2 * i], b1 = (int8_t)b8[2 * i + 1];
      const int l0 = ((int8_t)(uint8_t)(b8[2 * i] << 4)) >> 4;
      const int l1 = ((int8_t)(uint8_t)(b8[2 * i + 1] << 4)) >> 4;
      lo[i] = bcg::pack_bf16x2((float)l0 * sc, (float)l1 * sc);
      hi[i] = bcg::pack_bf16x2((float)(b0 >> 4) * sc, (float)(b1 >> 4) * sc);
    }
    uint4* dlo = reinterpret_cast<uint4*>(dst + j * 16);
    uint4* dhi = reinterpret_cast<uint4*>(dst + kDh / 2 + j * 16);
    dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
};

__device__ __forceinline__ float scale_to_float(float x) { return x; }
__device__ __forceinline__ float scale_to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Where position s of this block's (batch row, kv head) lives, in
// storage elements from the value base and the scale base.
// Dense cache: b * bstride + hk * hstride + s * sstride (scales: their
// own batch and head offset, positions contiguous).
struct DenseAddr {
  long long v_off, s_stride, sc_off;
  __device__ __forceinline__ long long val(int s) const { return v_off + s * s_stride; }
  __device__ __forceinline__ long long scl(int s) const { return sc_off + s; }
};

// Block pool: tbl[s / bs] * blk_stride + hk * hstride + (s % bs) * sstride
// (scales: tbl[s / bs] * sc_blk_stride + hk * sc_hstride + s % bs), with
// tbl this batch row's block ids from block blk0 on (the range of the
// table that this block's split covers), staged in shared memory.
struct PagedAddr {
  const int* tbl;
  int blk0, bs;
  long long blk_stride, v_hoff, s_stride, sc_blk_stride, sc_hoff;
  __device__ __forceinline__ long long val(int s) const {
    return (long long)tbl[s / bs - blk0] * blk_stride + v_hoff + (long long)(s % bs) * s_stride;
  }
  __device__ __forceinline__ long long scl(int s) const {
    return (long long)tbl[s / bs - blk0] * sc_blk_stride + sc_hoff + s % bs;
  }
};

constexpr int kLoadBatch = 4;   // chunks of K and of V in flight per thread
constexpr int kMaskRegs = 4;    // mask bytes a thread holds per iteration (pipelined loop)

// The split-S option (see the header).  len == 0: one split per (b, hk),
// the result written straight to `out`.
struct SplitS {
  int len = 0;               // positions per split, a multiple of kSuper
  float* part = nullptr;     // acc [B * Hkv][gridDim.z][R][kDh], then m, l [..][R][2]
  unsigned* count = nullptr; // [B * Hkv] arrivals; 0 between launches
};

// Positions [begin, end) of this block's split of an S-position window.
struct SplitRange {
  int begin, end;
};
__device__ __forceinline__ SplitRange split_range(int S, const SplitS& split) {
  if (!split.len) return SplitRange{0, S};
  const int z = blockIdx.z, begin = z * split.len;
  return SplitRange{begin, z + 1 < (int)gridDim.z ? begin + split.len : S};
}

// Occupancy of `kernel` (blocks resident on one SM) at `smem` bytes of
// dynamic shared memory, written to *blocks.
template <class Kernel>
int occupancy(Kernel kernel, size_t smem, int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

// kRing: compile the bf16 ring in (bf16 only; its extra live registers
// cost a block an SM at one m-tile, so launchers take it only for launches
// of two m-tiles or more).
template <int kLayout, bool kRing = false, class Addr>
__device__ __forceinline__ void decode_tile_body(
    const __nv_bfloat16* __restrict__ q,      // [B, Kq, H, Dh]
    const typename KVChunk<kLayout>::Elem* __restrict__ k,   // addressed through `addr`
    const typename KVChunk<kLayout>::Elem* __restrict__ v,
    const typename KVChunk<kLayout>::Scale* __restrict__ k_scale,   // quantized only
    const typename KVChunk<kLayout>::Scale* __restrict__ v_scale,
    const uint8_t* __restrict__ mask,         // [B, Mk, S], Mk = 1 or Kq
    __nv_bfloat16* __restrict__ out,          // [B, Kq, H, Dh]
    int S, int H, int Hkv, int Kq, int Mk, const Addr addr, float scale,
    int mask_div = 0,                         // rows per mask row; 0: G
    const SplitS split = SplitS{}) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hk = blockIdx.x, b = blockIdx.y;
  const int G = H / Hkv;
  const int R = Kq * G;
  const int nM = (R + 15) / 16;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + nM * 16 * kStride;
  __nv_bfloat16* Vs = Ks + kSuper * kStride;
  uint8_t* Ms = reinterpret_cast<uint8_t*>(Vs + kSuper * kStride);   // [Mk][kSuper]
  if (mask_div == 0) mask_div = G;
  // This block's range of positions [s_begin, s_end).
  const int nz = split.len ? (int)gridDim.z : 1, z = split.len ? (int)blockIdx.z : 0;
  const SplitRange range = split_range(S, split);
  const int s_begin = range.begin, s_end = range.end;
  const int nSplit = kWarps / nM;
  const int P = nSplit * kWN;                 // positions per iteration
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;     // mma fragment row group / column pair
  const int mt = warp % nM, sp = warp / nM;
  const bool active = sp < nSplit;            // nM = 3 leaves warp 3 to loading only
  const int wr = mt * 16;                     // this warp's first row
  const int wp0 = sp * kWN;                   // this warp's first position in an iteration

  auto q_row = [&](int r) -> long long {
    return (((long long)b * Kq + r / G) * H + hk * G + r % G) * kDh;
  };

  for (int c = tid; c < nM * 16 * (kDh / 8); c += kThreads) {
    const int r = c / (kDh / 8), col = (c % (kDh / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) val = *reinterpret_cast<const uint4*>(q + q_row(r) + col);
    *reinterpret_cast<uint4*>(Qs + r * kStride + col) = val;
  }
  __syncthreads();

  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + g) * kStride + kk * 16 + t4 * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
  }
  // The mask row of each of this thread's two fragment rows (g, g + 8);
  // -1 for rows past R, which stay fully masked.
  int mrow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wr + g + 8 * i;
    mrow[i] = r < R ? (Mk == 1 ? 0 : r / mask_div) : -1;
  }

  float o[kDh / 8][4];
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {bcg::kNegInf, bcg::kNegInf};
  float l_run[2] = {0.f, 0.f};

  const uint8_t* mb = mask + (long long)b * Mk * S;
  using Chunk = KVChunk<kLayout>;
  constexpr int kChunks = Chunk::kLoads;      // 16-byte loads per cache row
  constexpr int kRowBytes = row_bytes(kLayout);
  // The pipelined loops take a mask that fits their registers: the
  // quantized caches always (their raw rows staged apart), bf16 where two
  // m-tiles or more leave room for a second K/V stage (P <= 64 of the
  // kSuper rows).  The others load each iteration in turn.
  const bool fits = Mk * P <= kMaskRegs * kThreads;
  const bool pipelined = kLayout != kBf16 && fits;
  const bool bf16_ring = kRing && kLayout == kBf16 && nM >= 2 && fits;
  // The mask of the P positions from s0 into registers (pipelined loops).
  auto load_mask = [&](int s0, uint8_t (&m)[kMaskRegs]) {
#pragma unroll
    for (int i = 0; i < kMaskRegs; ++i) {
      const int c = tid + i * kThreads, r = c / P, col = c % P;
      m[i] = c < Mk * P && s0 + col < s_end ? mb[(long long)r * S + s0 + col] : 0;
    }
  };
  auto any_live = [](const uint8_t (&m)[kMaskRegs]) {
    int x = 0;
#pragma unroll
    for (int i = 0; i < kMaskRegs; ++i) x |= m[i];
    return x;
  };
  auto stage_mask = [&](const uint8_t (&m)[kMaskRegs]) {
#pragma unroll
    for (int i = 0; i < kMaskRegs; ++i) {
      const int c = tid + i * kThreads;
      if (c < Mk * P) Ms[(c / P) * kSuper + c % P] = m[i];
    }
  };

  // One iteration's products and online softmax over the K/V staged at
  // Kt/Vt and the staged mask.
  auto attend = [&](int s0, const __nv_bfloat16* Kt, const __nv_bfloat16* Vt) {
    if (!active || s0 + wp0 >= s_end) return;
    // scores = q . k^T for the warp's 16 rows x 32 positions.
    float sc[kWN / 8][4];
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kWN / 8; ++j) {
        const __nv_bfloat16* kr = Kt + (wp0 + j * 8 + g) * kStride + kk * 16 + t4 * 2;
        uint32_t bf[2];
        bf[0] = *reinterpret_cast<const uint32_t*>(kr);
        bf[1] = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(sc[j], qa[kk], bf);
      }
    }

    // Scale, mask, running max (element e: row g + 8*(e>=2), col 8j + 2*t4 + (e&1)).
    float mk[kWN / 8][4];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int mr = mrow[e >> 1];
        const int col = wp0 + j * 8 + t4 * 2 + (e & 1);
        mk[j][e] = (mr >= 0 && Ms[mr * kSuper + col]) ? 1.f : 0.f;
        const float val = mk[j][e] != 0.f ? sc[j][e] * scale : bcg::kNegInf;
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
    for (int j = 0; j < kWN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - mx[e >> 1]) * mk[j][e];
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
    // are the A fragment of position chunk kk.
#pragma unroll
    for (int kk = 0; kk < kWN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = bcg::pack_bf16x2(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = bcg::pack_bf16x2(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = bcg::pack_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = bcg::pack_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const unsigned short* vr =
          reinterpret_cast<const unsigned short*>(Vt) + (wp0 + kk * 16 + t4 * 2) * kStride + g;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        uint32_t bf[2];
        bf[0] = (uint32_t)vr[n * 8] | ((uint32_t)vr[n * 8 + kStride] << 16);
        bf[1] = (uint32_t)vr[n * 8 + 8 * kStride] | ((uint32_t)vr[n * 8 + 9 * kStride] << 16);
        mma_16816(o[n], pa, bf);
      }
    }
  };

  if (!pipelined && !bf16_ring) {
    for (int s0 = s_begin; s0 < s_end; s0 += P) {
      __syncthreads();   // the previous iteration's K/V/mask are no longer read
      int live = 0;
      for (int c = tid; c < Mk * P; c += kThreads) {
        const int r = c / P, col = c % P;
        const int s = s0 + col;
        const uint8_t mv = s < s_end ? mb[(long long)r * S + s] : 0;
        Ms[r * kSuper + col] = mv;
        live |= mv;
      }
      if (!__syncthreads_or(live)) continue;

      for (int c0 = tid; c0 < P * kChunks; c0 += kLoadBatch * kThreads) {
        Chunk kc[kLoadBatch], vc[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int c = c0 + u * kThreads;
          const int r = c / kChunks, j = c % kChunks;
          const int s = s0 + r;
          if (c < P * kChunks && s < s_end) {
            const long long vo = addr.val(s);
            const long long so = kLayout == kBf16 ? 0 : addr.scl(s);
            kc[u].load(k + vo, k_scale + so, j);
            vc[u].load(v + vo, v_scale + so, j);
          } else {
            kc[u].clear();
            vc[u].clear();
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int c = c0 + u * kThreads;
          if (c < P * kChunks) {
            const int r = c / kChunks, j = c % kChunks;
            kc[u].store(Ks + r * kStride, j);
            vc[u].store(Vs + r * kStride, j);
          }
        }
      }
      __syncthreads();
      attend(s0, Ks, Vs);
    }
  } else if constexpr (kRing && kLayout == kBf16) {
    // bf16 at two m-tiles or more: K and V of iteration i + 1 are copied
    // by cp.async into the other half of Ks/Vs (stage (i + 1) % 2, P rows
    // each) while iteration i is computed; positions past the range are
    // zero-filled, so that p = 0 never meets a stale value.  The mask runs
    // an iteration further ahead in registers, as in the quantized loop,
    // so that a dead iteration is never copied.
    auto prefetch = [&](int s0, int st) {
      __nv_bfloat16* kd = Ks + st * P * kStride;
      __nv_bfloat16* vd = Vs + st * P * kStride;
      for (int c = tid; c < P * kChunks; c += kThreads) {
        const int r = c / kChunks, j = c % kChunks;
        const bool in = s0 + r < s_end;
        const long long vo = in ? addr.val(s0 + r) : 0;
        cp_async16(kd + r * kStride + j * 8, k + vo + j * 8, in);
        cp_async16(vd + r * kStride + j * 8, v + vo + j * 8, in);
      }
    };
    uint8_t mcur[kMaskRegs], mnext[kMaskRegs], mafter[kMaskRegs];
    load_mask(s_begin, mcur);
    load_mask(s_begin + P, mnext);
    int cur_live = __syncthreads_or(any_live(mcur));
    if (cur_live) prefetch(s_begin, 0);
    int st = 0;
    for (int s0 = s_begin; s0 < s_end; s0 += P, st ^= 1) {
      stage_mask(mcur);
      if (cur_live) cp_async_wait_all();   // this iteration's copies, the only ones in flight
      load_mask(s0 + 2 * P, mafter);
      // This iteration's K/V and mask are visible; the other stage was
      // last read before the previous iteration's closing barrier.
      const int next_live = __syncthreads_or(any_live(mnext));
      if (next_live) prefetch(s0 + P, st ^ 1);
      if (cur_live) attend(s0, Ks + st * P * kStride, Vs + st * P * kStride);
      __syncthreads();   // this iteration's K/V stage and mask are no longer read
#pragma unroll
      for (int i = 0; i < kMaskRegs; ++i) {
        mcur[i] = mnext[i];
        mnext[i] = mafter[i];
      }
      cur_live = next_live;
    }
  } else if constexpr (kLayout != kBf16) {
    // Quantized caches: the raw rows of iteration i + 1 are copied into
    // RawK/RawV by cp.async (and their scales loaded into registers) while
    // iteration i is dequantized and computed; the mask runs one iteration
    // further ahead in registers, so that iteration i + 1 is known live
    // or dead (and then not loaded) before its copies start.
    unsigned char* RawK = reinterpret_cast<unsigned char*>(Ms + Mk * kSuper);
    unsigned char* RawV = RawK + kSuper * kRowBytes;
    float* ScK = reinterpret_cast<float*>(RawV + kSuper * kRowBytes);
    float* ScV = ScK + kSuper;
    // Scales of position s0 + tid of the copies in flight, as stored (read
    // as float only when staged, so that their loads stay in flight).
    using Scale = typename Chunk::Scale;
    Scale sk = Scale(0.f), sv = Scale(0.f);
    auto prefetch = [&](int s0) {
      for (int c = tid; c < P * kChunks; c += kThreads) {
        const int r = c / kChunks, j = c % kChunks;
        if (s0 + r < s_end) {
          const long long vo = addr.val(s0 + r);
          cp_async16(RawK + r * kRowBytes + j * 16, k + vo + j * 16);
          cp_async16(RawV + r * kRowBytes + j * 16, v + vo + j * 16);
        }
      }
      // A position past the range keeps a scale of 0: its stale raw row
      // (finite integers) dequantizes to 0.
      const bool in = tid < P && s0 + tid < s_end;
      sk = in ? k_scale[addr.scl(s0 + tid)] : Scale(0.f);
      sv = in ? v_scale[addr.scl(s0 + tid)] : Scale(0.f);
    };
    uint8_t mcur[kMaskRegs], mnext[kMaskRegs], mafter[kMaskRegs];
    load_mask(s_begin, mcur);
    load_mask(s_begin + P, mnext);
    int cur_live = __syncthreads_or(any_live(mcur));
    if (cur_live) prefetch(s_begin);
    for (int s0 = s_begin; s0 < s_end; s0 += P) {
      stage_mask(mcur);
      if (cur_live) {
        cp_async_wait_all();
        if (tid < P) {
          ScK[tid] = scale_to_float(sk);
          ScV[tid] = scale_to_float(sv);
        }
      }
      __syncthreads();   // this iteration's raw rows, scales and mask are visible
      if (cur_live) {
        for (int c = tid; c < P * kChunks; c += kThreads) {
          const int r = c / kChunks, j = c % kChunks;
          Chunk kc, vc;
          kc.raw = *reinterpret_cast<const uint4*>(RawK + r * kRowBytes + j * 16);
          vc.raw = *reinterpret_cast<const uint4*>(RawV + r * kRowBytes + j * 16);
          kc.sc = ScK[r];
          vc.sc = ScV[r];
          kc.store(Ks + r * kStride, j);
          vc.store(Vs + r * kStride, j);
        }
      }
      load_mask(s0 + 2 * P, mafter);
      // K/V staged and the raw buffer free again; is the next iteration live?
      const int next_live = __syncthreads_or(any_live(mnext));
      if (next_live) prefetch(s0 + P);
      if (cur_live) attend(s0, Ks, Vs);
      __syncthreads();   // this iteration's K/V/mask are no longer read
#pragma unroll
      for (int i = 0; i < kMaskRegs; ++i) {
        mcur[i] = mnext[i];
        mnext[i] = mafter[i];
      }
      cur_live = next_live;
    }
  }

  // Merge the position splits of each m-tile: m = max m_i, l = sum
  // alpha_i l_i, acc = sum alpha_i acc_i with alpha_i = exp(m_i - m).
  __syncthreads();   // K/V tiles are dead: their space holds the partials
  float* Os = reinterpret_cast<float*>(Ks);    // [kWarps][16][kDh]
  float* Mrun = Os + kWarps * 16 * kDh;        // [kWarps][16]
  float* Lrun = Mrun + kWarps * 16;
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int rl = g + 8 * i;
      float* orow = Os + (warp * 16 + rl) * kDh + t4 * 2;
#pragma unroll
      for (int n = 0; n < kDh / 8; ++n) {
        orow[n * 8] = o[n][2 * i];
        orow[n * 8 + 1] = o[n][2 * i + 1];
      }
      if (t4 == 0) {
        Mrun[warp * 16 + rl] = m_run[i];
        Lrun[warp * 16 + rl] = l_run[i];
      }
    }
  }
  __syncthreads();
  // One split: normalise and store.  Split-S: store this block's partials
  // (the workspace holds every pair's acc [nz][R][kDh] first, then every
  // pair's (m, l) [nz][R][2], so each acc row is 16-byte aligned).
  const long long pair = (long long)b * Hkv + hk;
  const long long npairs = (long long)gridDim.x * gridDim.y;
  float* part_acc = split.part + pair * nz * R * kDh;
  float* part_ml = split.part + npairs * nz * R * kDh + pair * nz * R * 2;
  for (int idx = tid; idx < R * kDh; idx += kThreads) {
    const int r = idx / kDh, d = idx % kDh;
    const int rt = r / 16, rl = r % 16;
    float m = bcg::kNegInf;
    for (int s = 0; s < nSplit; ++s) m = fmaxf(m, Mrun[(rt + s * nM) * 16 + rl]);
    float l = 0.f, acc = 0.f;
    for (int s = 0; s < nSplit; ++s) {
      const int w = rt + s * nM;
      const float a = expf(Mrun[w * 16 + rl] - m);
      l += a * Lrun[w * 16 + rl];
      acc += a * Os[(w * 16 + rl) * kDh + d];
    }
    if (nz == 1) {
      out[q_row(r) + d] = __float2bfloat16(acc / (l == 0.f ? 1.f : l));
    } else {
      part_acc[((long long)z * R + r) * kDh + d] = acc;
      if (d == 0) {
        part_ml[(z * R + r) * 2] = m;
        part_ml[(z * R + r) * 2 + 1] = l;
      }
    }
  }
  if (nz == 1) return;

  // The last block of this (b, hk) to arrive merges the splits in order:
  // one warp a row, each lane four of its columns (16-byte loads), so
  // the loads of all splits are in flight at once.
  __shared__ unsigned is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(split.count + pair, 1u) == (unsigned)(nz - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int r = warp; r < R; r += kWarps) {
    const float* ml = part_ml + r * 2;
    const float4* pa = reinterpret_cast<const float4*>(part_acc + (long long)r * kDh) + lane;
    const long long zstride = (long long)R * kDh / 4;   // float4s between splits
    float m = bcg::kNegInf;
    for (int s = 0; s < nz; ++s) m = fmaxf(m, __ldcg(ml + s * R * 2));
    float l = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < nz; ++s) {
      const float ls = __ldcg(ml + s * R * 2 + 1);
      const float w = ls > 0.f ? expf(__ldcg(ml + s * R * 2) - m) : 0.f;
      const float4 a = __ldcg(pa + s * zstride);
      l += w * ls;
      acc.x += w * a.x;
      acc.y += w * a.y;
      acc.z += w * a.z;
      acc.w += w * a.w;
    }
    const float den = l == 0.f ? 1.f : l;
    uint2 o;
    o.x = bcg::pack_bf16x2(acc.x / den, acc.y / den);
    o.y = bcg::pack_bf16x2(acc.z / den, acc.w / den);
    *reinterpret_cast<uint2*>(out + q_row(r) + lane * 4) = o;
  }
  if (tid == 0) split.count[pair] = 0u;
}

}  // namespace bcg_tile
