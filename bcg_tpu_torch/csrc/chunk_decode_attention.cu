// Chunk decode attention over the bf16 KV cache for Hopper (sm_90a):
// B3a-chunk.
//
// Replaces: bcg_tpu/ops/decode_attention.py::_decode_kernel, chunk form
// (the pallas_call :381 of chunk_decode_attention :308, bf16 cache).  It
// serves the fast-forward and speculative decode loops: every step
// attends a chunk of K positions (the sampled token plus forced or
// drafted tokens) over the whole cache, so each (batch row, kv head) has
// K * G query rows — 16 at bench-8b for fast-forward (K = 4, G = 32 / 8),
// 20 for the speculative verify (K = spec_k + 1 = 5).
//
// Computes out [B, K, H, Dh] from q [B, K, H, Dh], the cache k/v
// [B, S, Hkv, Dh] (strided views) and the mask [B, K, S]; query row r of
// a kv head reads mask row r / G, so the per-head repeat of the mask that
// the JAX wrapper builds on the host is never made.
//
// What bounds it on this card: like the single-step kernel it reads the
// whole cache window once per step (2 * S * Dh * 2 bytes per kv head) for
// 4 * K * G * S * Dh operations — about K * G / 2 = 8-10 operations per
// byte, far under the ~295 the tensor cores need, so it is bound by
// memory bytes.  The design is the shared tile body (decode_tile.cuh):
// both products on tensor cores (mma.sync m16n8k16), the K * G rows in
// 16-row m-tiles.  One block per (b, kv head), 80 at the bench shape on
// 132 SMs, left each block streaming the ~3100-position verify window
// alone, bound by one block's load latency; so the window is split over S
// as the single-step and int8 kernels' are: grid (Hkv, B, n_split) from
// ops/decode_attention.py::decode_split_plan at this kernel's own
// occupancy, the partials merged by the last block of each (b, kv head)
// in split order (one launch, deterministic, graph-capturable).  The
// verify's 20 rows take two m-tiles, so an iteration holds 64 positions
// and the shared memory sized for 128 holds two of them: the next
// iteration's K and V are copied by cp.async while this one is computed
// (the tile body's bf16 ring, in a kernel of its own: the ring's
// registers would cost a launch of one m-tile its third block an SM).
// Shared memory is sized by the launch's rows: 79 KB at R = 20, two
// blocks an SM.

#include "decode_tile.cuh"

namespace {

// kRing: the kernel with the tile body's bf16 ring, for launches of more
// than 16 rows (two m-tiles); the other keeps one m-tile's registers low
// (three blocks an SM at R <= 16).
template <bool kRing>
__global__ void __launch_bounds__(bcg_tile::kThreads)
chunk_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int Kq,
                         int Mk, long long kv_bstride, long long kv_hstride,
                         long long kv_sstride, float scale, const bcg_tile::SplitS split) {
  const bcg_tile::DenseAddr addr{
      (long long)blockIdx.y * kv_bstride + (long long)blockIdx.x * kv_hstride, kv_sstride, 0};
  bcg_tile::decode_tile_body<bcg_tile::kBf16, kRing>(
      q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), nullptr,
      nullptr, mask, out, S, H, Hkv, Kq, Mk, addr, scale, /*mask_div=*/0, split);
}

template <bool kRing>
cudaError_t set_smem() {
  static bool done = false;   // the attribute persists; set it to the most any launch takes
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(chunk_decode_bf16_kernel<kRing>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)bcg_tile::kSmemBytes);
  done = err == cudaSuccess;
  return err;
}

template <bool kRing>
int occupancy(int rows, int Mk, int* blocks) {
  cudaError_t err = set_smem<kRing>();
  if (err != cudaSuccess) return (int)err;
  return bcg_tile::occupancy(chunk_decode_bf16_kernel<kRing>,
                             bcg_tile::launch_smem(rows, Mk, bcg_tile::kBf16), blocks);
}

template <bool kRing>
int launch(const void* q, const void* k, const void* v, const void* mask, void* out, int B,
           int S, int H, int Hkv, int Kq, int Mk, long long kv_bstride, long long kv_hstride,
           long long kv_sstride, float scale, const bcg_tile::SplitS split, int n_split,
           cudaStream_t stream) {
  cudaError_t err = set_smem<kRing>();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B, n_split > 1 ? n_split : 1);
  chunk_decode_bf16_kernel<kRing><<<grid, bcg_tile::kThreads,
                                    bcg_tile::launch_smem(Kq * (H / Hkv), Mk, bcg_tile::kBf16),
                                    stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, Kq, Mk, kv_bstride, kv_hstride, kv_sstride,
      scale, split);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel resident on one SM at R = rows query rows and Mk
// mask rows (the split plan's occupancy), written to *blocks.  The
// layout and table arguments are the paged kernel's; unused here.
extern "C" int bcg_chunk_decode_attention_occupancy(int, int rows, int Mk, int, int, int, int,
                                                    int* blocks) {
  return rows > 16 ? occupancy<true>(rows, Mk, blocks) : occupancy<false>(rows, Mk, blocks);
}

// n_split == 1: no workspace (part and count may be null).  Otherwise part
// holds B * Hkv * n_split * Kq * G * (Dh + 2) floats and count B * Hkv
// unsigned ints, all 0 (the kernel leaves them 0 again).
extern "C" int bcg_chunk_decode_attention(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int B, int S, int H,
                                          int Hkv, int Kq, int Mk, long long kv_bstride,
                                          long long kv_hstride, long long kv_sstride,
                                          float scale, int n_split, int split_len, void* part,
                                          void* count, void* stream) {
  bcg_tile::SplitS split;
  if (n_split > 1) {
    split.len = split_len;
    split.part = static_cast<float*>(part);
    split.count = static_cast<unsigned*>(count);
  }
  cudaStream_t st = (cudaStream_t)stream;
  return Kq * (H / Hkv) > 16
             ? launch<true>(q, k, v, mask, out, B, S, H, Hkv, Kq, Mk, kv_bstride, kv_hstride,
                            kv_sstride, scale, split, n_split, st)
             : launch<false>(q, k, v, mask, out, B, S, H, Hkv, Kq, Mk, kv_bstride, kv_hstride,
                             kv_sstride, scale, split, n_split, st);
}
