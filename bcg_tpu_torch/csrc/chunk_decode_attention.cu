// Chunk decode attention over the bf16 KV cache for Hopper (sm_90a).
//
// Replaces: bcg_tpu/ops/decode_attention.py::_decode_kernel, chunk form
// (the pallas_call of chunk_decode_attention, bf16 cache).  It serves the
// fast-forward and speculative decode loops: every step attends a chunk
// of K positions (the sampled token plus forced or drafted tokens) over
// the whole cache, so each (batch row, kv head) has K * G query rows —
// 16 at bench-8b for fast-forward (K = 4, G = 32 / 8), 20 for the
// speculative verify (K = spec_k + 1 = 5).
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
// memory bytes.  The K * G rows are too many for PR 1's per-thread query
// registers (20 rows x 16 floats a thread would pass 255 registers), so
// the design (decode_tile.cuh) runs both products on tensor cores through
// mma.sync m16n8k16: one 16-row m-tile per warp, positions of each
// iteration split across the warps of an m-tile, splits merged at the end.
// One block per (b, kv head) — 80 at the bench shape — as in the
// single-step kernel; a split-S second pass is the next step.

#include "decode_tile.cuh"

namespace {

__global__ void __launch_bounds__(bcg_tile::kThreads)
chunk_decode_bf16_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                         const void* __restrict__ v, const uint8_t* __restrict__ mask,
                         __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int Kq,
                         int Mk, long long kv_bstride, long long kv_hstride,
                         long long kv_sstride, float scale) {
  const bcg_tile::DenseAddr addr{
      (long long)blockIdx.y * kv_bstride + (long long)blockIdx.x * kv_hstride, kv_sstride, 0};
  bcg_tile::decode_tile_body<bcg_tile::kBf16>(
      q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), nullptr,
      nullptr, mask, out, S, H, Hkv, Kq, Mk, addr, scale);
}

}  // namespace

extern "C" int bcg_chunk_decode_attention(const void* q, const void* k, const void* v,
                                          const void* mask, void* out, int B, int S, int H,
                                          int Hkv, int Kq, int Mk, long long kv_bstride,
                                          long long kv_hstride, long long kv_sstride,
                                          float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(chunk_decode_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bcg_tile::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  chunk_decode_bf16_kernel<<<grid, bcg_tile::kThreads, bcg_tile::kSmemBytes,
                             (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, Kq, Mk, kv_bstride, kv_hstride, kv_sstride,
      scale);
  return (int)cudaGetLastError();
}
