// Decode-step attention over the bf16 KV cache for Hopper (sm_90a): B3a.
//
// Replaces: bcg_tpu/ops/decode_attention.py::_decode_kernel (bf16 form;
// wrapper decode_attention).  On the TPU this block never lowered for
// Hkv > 1 and the bf16 decode ran as an XLA einsum; in the port it IS
// the decode step of the plain loop.
//
// Computes, per (batch b, kv head hk), for the group G = H / Hkv query
// rows of that kv head:
//   out[g] = sum_s softmax_s(scale * q[g].k[s], masked)[s] * v[s]
// over the cache k/v [B, S, Hkv, Dh] (S-major strided views: consecutive
// positions of one head sit kv_sstride elements apart).  The mask has M
// rows per batch row: 1 (shared by the group) or G (query row g reads
// mask row g).  Arithmetic as in the Pallas kernel: -1e30 sentinel,
// p = exp(s - m) * mask, l over the f32 p, p rounded to bf16 for the p.v
// product, acc / (l == 0 ? 1 : l).
//
// What bounds it on this card: the window is read once per step
// (2 * S * Dh * 2 bytes per kv head) for ~4 * G * S * Dh operations —
// about G / 2 operations per byte, far below the ~295 the tensor cores
// need: it is bound by memory bytes (115 MB a call at the bench-8b game
// shape, 0.034 ms at 3.35 TB/s).
//
// Design.  This is the shared tile body (decode_tile.cuh) with Kq = 1:
// the G rows sit in one 16-row m-tile, both products run on tensor cores
// (mma.sync m16n8k16), and the four warps split each 128-position
// iteration.  It replaces the first CUDA-core body (per-position shuffle
// dot products, one block of 128 threads per (kv head, batch row)),
// which read ~150 GB/s.  What held that body back was the grid as much
// as the math: B * Hkv = 80 blocks on 132 SMs, each streaming ~5000
// positions alone.  So the window is split (split-S, flash-decoding):
// grid (Hkv, B, n_split), n_split and the positions per split from
// ops/decode_attention.py::decode_split_plan (at least two blocks per SM
// where S allows), each block's partials merged by the last block of its
// (b, hk) in split order — one launch, deterministic, graph-capturable
// (the wrapper owns the workspace and its arrival counters).  Shared
// memory is sized for 16 rows (74 KB), so three blocks fit on an SM.
// Head dim 128; G up to 64.

#include "decode_tile.cuh"

namespace {

__global__ void __launch_bounds__(bcg_tile::kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int M,
                        long long kv_bstride, long long kv_sstride, float scale,
                        const bcg_tile::SplitS split) {
  const bcg_tile::DenseAddr addr{
      (long long)blockIdx.y * kv_bstride + (long long)blockIdx.x * bcg_tile::kDh, kv_sstride,
      0};
  // q [B, H, Dh] is q [B, 1, H, Dh]; mask [B, M, S] with row g for query row g.
  bcg_tile::decode_tile_body<bcg_tile::kBf16>(q, k, v, nullptr, nullptr, mask, out, S, H, Hkv,
                                              /*Kq=*/1, M, addr, scale, /*mask_div=*/1, split);
}

cudaError_t set_smem() {
  static bool done = false;   // the attribute persists; set it to the most any launch takes
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bcg_tile::kSmemBytes);
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Blocks of the kernel resident on one SM at R = rows query rows (the
// group) and M mask rows (the split plan's occupancy), written to
// *blocks.  The layout and table arguments are the paged kernel's; unused
// here.
extern "C" int bcg_decode_attention_occupancy(int, int rows, int M, int, int, int, int,
                                              int* blocks) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  return bcg_tile::occupancy(decode_attention_kernel,
                             bcg_tile::launch_smem(rows, M, bcg_tile::kBf16), blocks);
}

// n_split == 1: no workspace (part and count may be null).  Otherwise part
// holds B * Hkv * n_split * G * (Dh + 2) floats and count B * Hkv
// unsigned ints, all 0 (the kernel leaves them 0 again).
extern "C" int bcg_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int S, int H,
                                    int Hkv, int M, long long kv_bstride,
                                    long long kv_sstride, float scale, int n_split,
                                    int split_len, void* part, void* count, void* stream) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  bcg_tile::SplitS split;
  if (n_split > 1) {
    split.len = split_len;
    split.part = static_cast<float*>(part);
    split.count = static_cast<unsigned*>(count);
  }
  dim3 grid(Hkv, B, n_split > 1 ? n_split : 1);
  decode_attention_kernel<<<grid, bcg_tile::kThreads,
                            bcg_tile::launch_smem(H / Hkv, M, bcg_tile::kBf16),
                            (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, M, kv_bstride, kv_sstride, scale, split);
  return (int)cudaGetLastError();
}
