// Flash prefill attention for Hopper (sm_90a), bf16 in, f32 accumulate: B1.
//
// Replaces: bcg_tpu/ops/attention.py::_flash_kernel (the Pallas TPU
// kernel behind _pallas_flash / flash_attention).
//
// Computes, per (batch b, query head h):
//   out[t] = sum_s softmax_s(scale * q[t].k[s], masked)[s] * v[s]
// with GQA (query head h reads kv head h / G, G = H / Hkv) and an
// ARBITRARY boolean mask [B, T, S] (cached prefix plus left padding, or
// the paged prefill's right padding — not causal by construction).  The
// arithmetic is the Pallas kernel's: masked scores take the finite -1e30
// sentinel, p = exp(score - m_new) * mask (so a fully masked row keeps
// p == 0), l sums the f32 p, the p.v product uses p rounded to bf16, and
// the result is acc / (l == 0 ? 1 : l) — fully masked rows give 0.
//
// What bounds it on this card: at game shapes (T ~ 4K suffix rows over
// S ~ 5K keys, Dh = 128) the two matrix products over the live (query,
// key) pairs: ~4 * Dh * H operations per live pair against ~B * T * S
// bytes of mask and each K/V row read once — bound by tensor-core
// operations (0.60 ms at 989 TFLOP/s at the sampled game's largest
// prefill on bench-8b).
//
// Design.  The first version (one block of 64 rows per (query tile, query
// head), mma.sync, the mask scanned byte by byte, nothing in flight)
// took 28x that bound.  This one:
//   * Reads the mask once per call.  A pre-pass (mask_pack_kernel, one
//     more launch) packs [B, T, S] bool into bits, one 32-bit word per 32
//     keys ([B, T, Wp], Wp a multiple of 4), with 16-byte loads where S is
//     a multiple of 16, and writes one live flag per (b, query tile,
//     128-key tile).  The main kernel walks only the live tiles (a flag
//     byte each) and reads 16 bytes of bits per position and live tile.
//     Bytes: the mask once (B * T * S), the bits written once (B * T * S
//     / 8) and read once per kv head and live tile, the flags
//     B * nQT * ceil(S / 128).  The first version read the mask bytes
//     once per query head and tile, live or dead: 32 times at bench-8b.
//   * Packs the GQA group into a block.  One block per (query tile, kv
//     head, batch row); its 192 rows are (position, query head) pairs,
//     position major (row r: position r / G, head hk * G + r % G), so
//     every K/V tile and mask word serves all G heads (the first version
//     loaded them once per query head).  A block takes floor(192 / G)
//     positions: 48 at G = 4; a group that does not divide 192 (5, 7:
//     38, 27 positions) leaves 192 mod G padding rows, zero q and masked
//     everywhere.
//   * Keeps K/V in flight: a ring of two stages (K, V and the tile's mask
//     bits, 67 KB each) filled by cp.async 16-byte copies (zero-filled
//     past S) one live tile ahead of the math.  cp.async, not TMA: the
//     K/V views are strided cache slices whose base changes with every
//     layer and call, and encoding a tensor map per call costs host time
//     on a host-bound path.
//   * Runs both products on wgmma, three consumer warpgroups of 64 rows:
//     S = Q.K^T (m64n128k16, Q and K from shared memory, K-major with the
//     128-byte swizzle: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
//     of its 128-byte line, each 64-column half of a tile its own block
//     of lines; SBO 1024 B), then O += P.V (m64n128k16) with P from
//     registers (the S accumulator rounded to bf16 is already the A
//     fragment) and V read N-major through the descriptor's transpose
//     bit (LBO = the distance between the two 64-column halves, SBO 1024
//     B), so V needs no transposed copy.  The ring is written through the
//     generic proxy, so each thread fences (fence.proxy.async) before the
//     barrier that hands a stage to wgmma.
//   * Skips the bit tests where a thread's mask words are all live.
// On an H100 at synthetic bench-8b shapes this configuration (192 rows,
// 128-key tiles, 2 stages, the all-live fast path) ran faster than 128
// rows, 64-key tiles, 3 or 4 stages, or Q.K^T with Q from registers.
// Not yet: TMA, a producer warp, overlap of one tile's softmax with the
// next tile's Q.K^T within a warpgroup (a first try had ptxas serialize
// the wgmma chain).  Head dim 128; groups up to 192.

#include "common.cuh"

namespace {

constexpr int kDh = 128;
constexpr int kRows = 192;                   // (position, head) rows per block
constexpr int kBN = 128;                     // keys per tile
constexpr int kStages = 2;                   // K/V ring depth
constexpr int kThreads = kRows / 64 * 128;   // one warpgroup per 64 rows
constexpr int kWords = kBN / 32;             // mask words per position per tile
constexpr int kTileBytes = kBN * kDh * 2;    // one K or V tile
constexpr int kQBytes = kRows * kDh * 2;
constexpr int kBitsBytes = (kRows * kWords * 4 + 1023) / 1024 * 1024;
constexpr int kStageBytes = 2 * kTileBytes + kBitsBytes;   // K, V, mask bits
constexpr size_t kSmemBytes = kQBytes + (size_t)kStages * kStageBytes + 1024;   // + alignment
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kStageBytes % 1024 == 0, "stages keep the 1024-byte swizzle alignment");
static_assert(kBN == 128, "Q.K^T is one m64n128k16 chain per warpgroup");

// Byte offset of 16-byte chunk c16 (0..15) of row `row` in a tile of
// `nrows` rows of kDh bf16: two 64-column halves, each nrows lines of
// 128 bytes, chunks swizzled within a line by row % 8 (the 128-byte
// swizzle wgmma and TMA use; the tile base is 1024-byte aligned).
__device__ __forceinline__ int swz(int row, int c16, int nrows) {
  return (c16 >> 3) * nrows * 128 + row * 128 + (((c16 & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator register above
// the wgmma wait that makes it valid.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }

// wgmma shared-memory descriptor, 128-byte swizzle; lbo / sbo in bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// d[64] (+)= A . B^T: A 64 x 16 and B 128 x 16, both K-major in shared
// memory (128-byte swizzle); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64] (+)= A . B: A 64 x 16 in registers (per warp, the mma.sync
// A-fragment layout), B 16 x 128 in shared memory N-major (imm-trans-b);
// scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Four mask bytes (each 0 or 1) -> four bits, byte i to bit i.
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Packs the [B, T, S] bool mask into bits [B, T, Wp] (bit i of word w of a
// row: key 32 w + i; zero past S) and one live flag per (b, query tile of
// tp positions, 64-key tile) into flags [B, nQT, nKT].  Grid (nQT, B).
__global__ void __launch_bounds__(256)
mask_pack_kernel(const uint8_t* __restrict__ mask, uint32_t* __restrict__ bits,
                 uint8_t* __restrict__ flags, int T, int S, int Wp, int nQT, int nKT, int tp,
                 int vec) {
  const int qt = blockIdx.x, b = blockIdx.y;
  const int t0 = qt * tp;
  for (int w0 = 0; w0 < Wp; w0 += 256) {
    const int w = w0 + threadIdx.x;
    uint32_t any = 0;
    for (int p = 0; p < tp && t0 + p < T; ++p) {
      const long long row = (long long)b * T + t0 + p;
      uint32_t word = 0;
      const int s0 = w * 32;
      if (w < Wp && s0 < S) {
        const uint8_t* src = mask + row * S + s0;
        if (vec && s0 + 32 <= S) {
          const uint4 a = *reinterpret_cast<const uint4*>(src);
          const uint4 c = *reinterpret_cast<const uint4*>(src + 16);
          word = nibble(a.x) | nibble(a.y) << 4 | nibble(a.z) << 8 | nibble(a.w) << 12 |
                 nibble(c.x) << 16 | nibble(c.y) << 20 | nibble(c.z) << 24 | nibble(c.w) << 28;
        } else {
          for (int i = 0; i < 32 && s0 + i < S; ++i) word |= (uint32_t)(src[i] != 0) << i;
        }
      }
      if (w < Wp) bits[row * Wp + w] = word;
      any |= word;
    }
    // Tile j holds words kWords j .. kWords j + kWords - 1: neighbouring lanes.
#pragma unroll
    for (int o = 1; o < kWords; o <<= 1) any |= __shfl_xor_sync(0xffffffffu, any, o);
    if (w < Wp && w % kWords == 0 && w / kWords < nKT)
      flags[((long long)b * nQT + qt) * nKT + w / kWords] = any != 0u;
  }
}

__device__ __forceinline__ int next_live(const uint8_t* __restrict__ f, int j, int n) {
  while (j < n && !__ldg(f + j)) ++j;
  return j;
}

__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,    // [B, T, H, Dh]
                     const __nv_bfloat16* __restrict__ k,    // [B, S, Hkv, Dh] strided
                     const __nv_bfloat16* __restrict__ v,
                     const uint32_t* __restrict__ bits,      // [B, T, Wp]
                     const uint8_t* __restrict__ flags,      // [B, nQT, nKT]
                     __nv_bfloat16* __restrict__ out,        // [B, T, H, Dh]
                     int T, int S, int H, int Hkv, int Wp, int nQT, int nKT, int tp,
                     long long kv_bstride, long long kv_sstride, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* Qs = smem;
  auto Ks = [&](int st) { return smem + kQBytes + st * kStageBytes; };
  auto Vs = [&](int st) { return Ks(st) + kTileBytes; };
  auto Bs = [&](int st) { return reinterpret_cast<uint32_t*>(Ks(st) + 2 * kTileBytes); };

  const int qt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int t0 = qt * tp;
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int t4 = lane & 3;
  const uint8_t* frow = flags + ((long long)b * nQT + qt) * nKT;

  // Q rows (position r / G, head r % G) -> shared memory; padding rows zero.
  for (int c = tid; c < kRows * 16; c += kThreads) {
    const int r = c >> 4, c16 = c & 15;
    const int p = r / G, t = t0 + p;
    const bool ok = p < tp && t < T;
    const __nv_bfloat16* src =
        ok ? q + (((long long)b * T + t) * H + hk * G + r % G) * kDh + c16 * 8 : q;
    cp_async16(Qs + swz(r, c16, kRows), src, ok);
  }

  auto load_tile = [&](int tile, int st) {
    const int key0 = tile * kBN;
    unsigned char* kd = Ks(st);
    unsigned char* vd = Vs(st);
    for (int c = tid; c < kBN * 16; c += kThreads) {
      const int r = c >> 4, c16 = c & 15;
      const int s = key0 + r;
      const bool ok = s < S;
      const long long off = ok ? (long long)b * kv_bstride + (long long)s * kv_sstride +
                                     (long long)hk * kDh + c16 * 8
                               : 0;
      cp_async16(kd + swz(r, c16, kBN), k + off, ok);
      cp_async16(vd + swz(r, c16, kBN), v + off, ok);
    }
    uint32_t* bd = Bs(st);
    for (int p = tid; p < tp; p += kThreads) {
      const bool ok = t0 + p < T;
      const uint32_t* src = ok ? bits + ((long long)b * T + t0 + p) * Wp + tile * kWords : bits;
      cp_async16(bd + p * kWords, src, ok);   // kWords = 4: one 16-byte chunk
    }
  };

  // Prologue: kStages - 1 live tiles in flight (Q rides with the first).
  int cur = next_live(frow, 0, nKT);
  int ld = cur;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (ld < nKT) {
      load_tile(ld, st);
      ld = next_live(frow, ld + 1, nKT);
    }
    cp_async_commit();
  }

  // This thread's two rows of its warpgroup's 64: r and r + 8.
  int prow[2];
  bool valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    prow[i] = r / G;
    valid[i] = prow[i] < tp && t0 + prow[i] < T;
  }

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m_run[2] = {bcg::kNegInf, bcg::kNegInf};
  float l_run[2] = {0.f, 0.f};
  const unsigned char* q_wg = Qs + wg * 64 * 128;

  for (int it = 0; cur < nKT; ++it) {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();
    __syncthreads();   // tile `it` is in; every warpgroup is done with tile it - 1
    if (ld < nKT) {
      load_tile(ld, (it + kStages - 1) % kStages);
      ld = next_live(frow, ld + 1, nKT);
    }
    cp_async_commit();
    const int st = it % kStages;

    // S = Q . K^T: 64 rows x kBN keys per warpgroup, 8 steps of 16 dims.
    float sc[kBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      const int half = kk >> 2, off = (kk & 3) * 32;
      const uint64_t kdesc = smem_desc(Ks(st) + half * kBN * 128 + off, 16, 1024);
      const uint64_t qdesc = smem_desc(q_wg + half * kRows * 128 + off, 16, 1024);
      wgmma_m64n128k16_ss(sc, qdesc, kdesc, kk > 0);
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) reg_fence(sc[i]);

    // Mask, scale (log2 domain), running max, p.  Element 4j + e: row
    // i = e >> 1, key 8j + 2 t4 + (e & 1), which is bit
    // 8 (j % 4) + 2 t4 + (e & 1) of the row's word j / 4.
    const uint32_t* bw = Bs(st);
    uint32_t mw[2][kWords];
    bool all_live = true;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        mw[i][w] = valid[i] ? bw[prow[i] * kWords + w] : 0u;
        all_live &= mw[i][w] == 0xffffffffu;
      }
    // Words all live (the common case inside a prefix or below the
    // diagonal) skip the bit tests.  The two branches differ per quad
    // (rows), so the shuffles stay outside them, where the warp is
    // converged.
    float mx[2] = {m_run[0], m_run[1]};
    if (all_live) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[4 * j + e] *= scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
        }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bit = (j & 3) * 8 + t4 * 2 + (e & 1);
          const bool live = (mw[e >> 1][j >> 2] >> bit) & 1u;
          const float val = live ? sc[4 * j + e] * scale_log2 : bcg::kNegInf;
          sc[4 * j + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
    }
    if (all_live) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[4 * j + e] - mx[e >> 1]);
          sc[4 * j + e] = p;
          rs[e >> 1] += p;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int bit = (j & 3) * 8 + t4 * 2 + (e & 1);
          const bool live = (mw[e >> 1][j >> 2] >> bit) & 1u;
          const float p = live ? exp2f(sc[4 * j + e] - mx[e >> 1]) : 0.f;
          sc[4 * j + e] = p;
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
      o[4 * n + 0] *= alpha[0];
      o[4 * n + 1] *= alpha[0];
      o[4 * n + 2] *= alpha[1];
      o[4 * n + 3] *= alpha[1];
    }

    // O += P(bf16) . V: kBN / 16 steps of 16 keys; the S accumulators of
    // key groups 2kk and 2kk + 1 are the A fragment of step kk.
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = bcg::pack_bf16x2(sc[8 * kk + 0], sc[8 * kk + 1]);
      pa[kk][1] = bcg::pack_bf16x2(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = bcg::pack_bf16x2(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = bcg::pack_bf16x2(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wgmma_m64n128k16_rs(o, pa[kk], smem_desc(Vs(st) + kk * 16 * 128, kBN * 128, 1024), 1);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int i = 0; i < 64; ++i) reg_fence(o[i]);

    cur = next_live(frow, cur + 1, nKT);
  }
  cp_async_wait<0>();

  // out = acc / (l == 0 ? 1 : l); padding rows and rows past T dropped.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!valid[i]) continue;
    const int r = wg * 64 + warp * 16 + (lane >> 2) + 8 * i;
    const float inv = 1.f / (l_run[i] == 0.f ? 1.f : l_run[i]);
    __nv_bfloat16* orow =
        out + (((long long)b * T + t0 + prow[i]) * H + hk * G + r % G) * kDh + t4 * 2;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          bcg::pack_bf16x2(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
    }
  }
}

}  // namespace

// The wrapper allocates bits ([B, T, Wp] int32, Wp = ceil(S / 32) rounded
// up to a multiple of 4) and flags ([B, ceil(T / tp), ceil(S / 128)]
// uint8, tp = 192 / G positions a block); the pre-pass writes both before
// the main kernel reads them.
extern "C" int bcg_flash_prefill(const void* q, const void* k, const void* v,
                                 const void* mask, void* bits, void* flags, void* out, int B,
                                 int T, int S, int H, int Hkv, int Wp, long long kv_bstride,
                                 long long kv_sstride, float scale, void* stream) {
  static bool smem_set = false;   // the attribute persists
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_set = true;
  }
  const int G = H / Hkv;
  const int tp = kRows / G;
  const int nQT = (T + tp - 1) / tp, nKT = (S + kBN - 1) / kBN;
  cudaStream_t st = (cudaStream_t)stream;
  const int vec = (S % 16 == 0) && (reinterpret_cast<uintptr_t>(mask) % 16 == 0);
  mask_pack_kernel<<<dim3(nQT, B), 256, 0, st>>>(
      static_cast<const uint8_t*>(mask), static_cast<uint32_t*>(bits),
      static_cast<uint8_t*>(flags), T, S, Wp, nQT, nKT, tp, vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_prefill_kernel<<<dim3(nQT, Hkv, B), kThreads, kSmemBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint32_t*>(bits),
      static_cast<const uint8_t*>(flags), static_cast<__nv_bfloat16*>(out), T, S, H, Hkv, Wp,
      nQT, nKT, tp, kv_bstride, kv_sstride, scale * kLog2e);
  return (int)cudaGetLastError();
}
