// Decode attention over the int8 KV cache for Hopper (sm_90a), single
// step and chunk: B3b.
//
// Replaces: bcg_tpu/ops/decode_attention.py::_decode_kernel_allheads (the
// pallas_call of _quantized_attention), reached from decode_attention
// (rows = G) and chunk_decode_attention (rows = K * G) when k_scale is
// given.  It serves the int8-cache decode of the plain, fast-forward and
// speculative loops.
//
// Computes out [B, Kq, H, Dh] (Kq = 1 for a single step) from q
// [B, Kq, H, Dh], the int8 cache k/v [B, Hkv, S, Dh] with f32
// per-(position, kv head) scales [B, Hkv, S], and the mask [B, Mk, S]
// (Mk = 1: one row shared by every query row; Mk = Kq: query row r reads
// row r / G).  Each value is dequantized in registers as the TPU kernel
// does it — float(v) * scale, rounded to bf16 — before either product.
// The TPU wrappers pad a non-power-of-two group up to the next power of
// two (a Mosaic constraint); the rows here need no padding.
//
// What bounds it on this card: the cache window is read once per step,
// 2 * S * (Dh + 4) bytes per kv head (int8 values plus scales), about
// half of the bf16 cache's bytes, for 4 * Kq * G * S * Dh operations —
// far under the tensor cores' ~295 operations per byte, so it is bound
// by memory bytes.  The design (decode_tile.cuh) streams one kv head's
// consecutive positions (128 bytes apart in this layout) with 16-byte
// loads, dequantizes into shared memory, and runs both products on
// tensor cores (mma.sync m16n8k16).  One block per (b, kv head) — 80 at
// the bench shape, on 132 SMs — left each block streaming ~5000
// positions alone, bound by one block's load latency; so the window is
// split over S as B3a's is: grid (Hkv, B, n_split) from
// ops/decode_attention.py::decode_split_plan at this kernel's own
// occupancy, the partials merged by the last block of each (b, kv head)
// in split order (one launch, deterministic, graph-capturable).  The raw
// rows of the next iteration are copied by cp.async while this one is
// dequantized and computed (decode_tile.cuh).  Shared memory is sized by
// the launch's rows: 108 KB at R <= 16 and 113 KB for the speculative
// chunk's R = 20 with the staging buffer, two blocks an SM.

#include "decode_tile.cuh"

namespace {

__global__ void __launch_bounds__(bcg_tile::kThreads)
decode_int8_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k,
                   const void* __restrict__ v, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const uint8_t* __restrict__ mask,
                   __nv_bfloat16* __restrict__ out, int S, int H, int Hkv, int Kq, int Mk,
                   long long kv_bstride, long long kv_hstride, long long kv_sstride,
                   long long sc_bstride, long long sc_hstride, float scale,
                   const bcg_tile::SplitS split) {
  const bcg_tile::DenseAddr addr{
      (long long)blockIdx.y * kv_bstride + (long long)blockIdx.x * kv_hstride, kv_sstride,
      (long long)blockIdx.y * sc_bstride + (long long)blockIdx.x * sc_hstride};
  bcg_tile::decode_tile_body<bcg_tile::kInt8>(
      q, static_cast<const int8_t*>(k), static_cast<const int8_t*>(v), k_scale, v_scale, mask,
      out, S, H, Hkv, Kq, Mk, addr, scale, /*mask_div=*/0, split);
}

cudaError_t set_smem() {
  static bool done = false;   // the attribute persists; set it to the most any launch takes
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      decode_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(bcg_tile::kSmemBytes + bcg_tile::raw_bytes(bcg_tile::kInt8)));
  done = err == cudaSuccess;
  return err;
}

}  // namespace

// Blocks of the kernel resident on one SM at R = rows query rows and Mk
// mask rows (the split plan's occupancy), written to *blocks.  The
// layout and table arguments are the paged kernel's; unused here.
extern "C" int bcg_decode_attention_int8_occupancy(int, int rows, int Mk, int, int, int, int,
                                                   int* blocks) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  return bcg_tile::occupancy(decode_int8_kernel,
                             bcg_tile::launch_smem(rows, Mk, bcg_tile::kInt8), blocks);
}

// n_split == 1: no workspace (part and count may be null).  Otherwise part
// holds B * Hkv * n_split * Kq * G * (Dh + 2) floats and count B * Hkv
// unsigned ints, all 0 (the kernel leaves them 0 again).
extern "C" int bcg_decode_attention_int8(const void* q, const void* k, const void* v,
                                         const void* k_scale, const void* v_scale,
                                         const void* mask, void* out, int B, int S, int H,
                                         int Hkv, int Kq, int Mk, long long kv_bstride,
                                         long long kv_hstride, long long kv_sstride,
                                         long long sc_bstride, long long sc_hstride,
                                         float scale, int n_split, int split_len, void* part,
                                         void* count, void* stream) {
  cudaError_t err = set_smem();
  if (err != cudaSuccess) return (int)err;
  bcg_tile::SplitS split;
  if (n_split > 1) {
    split.len = split_len;
    split.part = static_cast<float*>(part);
    split.count = static_cast<unsigned*>(count);
  }
  dim3 grid(Hkv, B, n_split > 1 ? n_split : 1);
  decode_int8_kernel<<<grid, bcg_tile::kThreads,
                       bcg_tile::launch_smem(Kq * (H / Hkv), Mk, bcg_tile::kInt8),
                       (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const uint8_t*>(mask),
      static_cast<__nv_bfloat16*>(out), S, H, Hkv, Kq, Mk, kv_bstride, kv_hstride, kv_sstride,
      sc_bstride, sc_hstride, scale, split);
  return (int)cudaGetLastError();
}
