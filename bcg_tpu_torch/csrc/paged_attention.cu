// Paged decode attention over a block pool for Hopper (sm_90a): bf16,
// int8 and packed-int4 pools, single step and chunk.
//
// Replaces: bcg_tpu/ops/paged_attention.py::_paged_kernel (the
// pallas_call of _paged_pallas_attention), reached from
// paged_decode_attention (rows = G, one mask row) and
// paged_chunk_attention (rows = K * G, mask row r / G).  It serves the
// paged KV cache under the plain, fast-forward and speculative loops.
//
// Computes out [B, Kq, H, Dh] (Kq = 1 for a single step) from q
// [B, Kq, H, Dh] and a per-layer block pool read through the block
// table tbl [B, nblk] int32: logical slot s of batch row b lives at
// pool block tbl[b, s / bs], offset s % bs.  Pools: bf16 [N, bs, Hkv,
// Dh]; int8 [N, Hkv, bs, Dh] with f32 scales [N, Hkv, bs]; packed int4
// [N, Hkv, bs, Dh/2] with bf16 scales [N, Hkv, bs] (byte j: element j in
// the low nibble, j + Dh/2 in the high nibble).  Block 0 is the null
// block: table padding points at it, it holds zeros, and every slot it
// backs is masked out, so it contributes nothing.  The mask is
// [B, Mk, S] with S = nblk * bs.
//
// What bounds it on this card: a step reads each live block of the row
// once — K and V of bs positions per kv head (2 * bs * Dh * 2 bytes
// bf16, 2 * bs * (Dh + 4) int8, 2 * bs * (Dh / 2 + 2) int4) — for
// 4 * Kq * G * Dh operations per position, far under the ~295
// operations per byte the tensor cores need: it is bound by memory
// bytes.  The design is the dense decode kernels' body
// (decode_tile.cuh, mma.sync m16n8k16, one block per (b, kv head)) with
// the position address taken through the table: the row's table is
// staged in shared memory once per block (about 400 ints at the bench
// shape), and each 16-byte load of a position's row goes to its block.
// Pages are not grouped per program as on the TPU (that amortised the
// TPU's fixed cost per grid step); blocks that no query row of an
// iteration attends are not loaded.  Like the dense kernels, 80 blocks
// at the bench shape leave SMs idle; a split-S pass is later work.

#include "decode_tile.cuh"

namespace {

template <int kLayout>
__global__ void __launch_bounds__(bcg_tile::kThreads)
paged_kernel(const __nv_bfloat16* __restrict__ q,
             const typename bcg_tile::KVChunk<kLayout>::Elem* __restrict__ k,
             const typename bcg_tile::KVChunk<kLayout>::Elem* __restrict__ v,
             const typename bcg_tile::KVChunk<kLayout>::Scale* __restrict__ k_scale,
             const typename bcg_tile::KVChunk<kLayout>::Scale* __restrict__ v_scale,
             const int* __restrict__ tbl, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int nblk, int bs, int H, int Hkv, int Kq, int Mk,
             long long blk_stride, long long h_stride, long long s_stride,
             long long sc_blk_stride, long long sc_h_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + bcg_tile::kSmemBytes);
  const int hk = blockIdx.x, b = blockIdx.y;
  const int* row = tbl + (long long)b * nblk;
  for (int i = threadIdx.x; i < nblk; i += bcg_tile::kThreads) tbl_s[i] = row[i];
  __syncthreads();
  const bcg_tile::PagedAddr addr{tbl_s, bs, blk_stride, (long long)hk * h_stride, s_stride,
                                 sc_blk_stride, (long long)hk * sc_h_stride};
  bcg_tile::decode_tile_body<kLayout>(q, k, v, k_scale, v_scale, mask, out, nblk * bs, H, Hkv,
                                      Kq, Mk, addr, scale);
}

template <int kLayout>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tbl, const void* mask, void* out, int B, int nblk,
           int bs, int H, int Hkv, int Kq, int Mk, long long blk_stride, long long h_stride,
           long long s_stride, long long sc_blk_stride, long long sc_h_stride, float scale,
           cudaStream_t stream) {
  using Chunk = bcg_tile::KVChunk<kLayout>;
  const size_t smem = bcg_tile::kSmemBytes + (size_t)nblk * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<kLayout>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(Hkv, B);
  paged_kernel<kLayout><<<grid, bcg_tile::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const typename Chunk::Elem*>(k),
      static_cast<const typename Chunk::Elem*>(v),
      static_cast<const typename Chunk::Scale*>(k_scale),
      static_cast<const typename Chunk::Scale*>(v_scale), static_cast<const int*>(tbl),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), nblk, bs, H, Hkv, Kq,
      Mk, blk_stride, h_stride, s_stride, sc_blk_stride, sc_h_stride, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// layout: 0 bf16, 1 int8, 2 packed int4 (bcg_tile::Layout).  Strides are
// in storage elements: blk/h/s of the value pool, blk/h of the scales
// (positions contiguous).
extern "C" int bcg_paged_attention(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* tbl,
                                   const void* mask, void* out, int B, int nblk, int bs, int H,
                                   int Hkv, int Kq, int Mk, int layout, long long blk_stride,
                                   long long h_stride, long long s_stride,
                                   long long sc_blk_stride, long long sc_h_stride, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case bcg_tile::kBf16:
      return launch<bcg_tile::kBf16>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, st);
    case bcg_tile::kInt8:
      return launch<bcg_tile::kInt8>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, st);
    case bcg_tile::kInt4:
      return launch<bcg_tile::kInt4>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
