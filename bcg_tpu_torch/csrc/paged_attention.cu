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
// (decode_tile.cuh, mma.sync m16n8k16) with the position address taken
// through the table, each 16-byte load of a position's row going to its
// block.  Pages are not grouped per program as on the TPU (that
// amortised the TPU's fixed cost per grid step); blocks that no query
// row of an iteration attends are not loaded.  One block per (b, kv
// head) — 80 at the bench shape, on 132 SMs — left each block streaming
// the row alone, bound by one block's load latency; so the window is
// split over S as the dense kernels' is: grid (Hkv, B, n_split) from
// ops/decode_attention.py::decode_split_plan at this kernel's occupancy,
// every split a whole number of pool blocks (split_len a multiple of
// lcm(128, bs)), the partials merged by the last block of each (b, kv
// head) in split order.  Each block stages only its split's range of the
// table in shared memory (about 80 ints at the bench shape), after the
// tile's buffers, which are sized by the launch's rows and layout (the
// int8 and int4 pools' raw rows are copied by cp.async an iteration
// ahead of their dequantization, and a bf16 launch of more than 16 rows
// takes the kernel with the bf16 ring, the next iteration's K and V
// copied while this one is computed: decode_tile.cuh).

#include "decode_tile.cuh"

namespace {

// kRing: the bf16 pool's kernel with the tile body's bf16 ring (for
// launches of more than 16 rows; it costs a launch of one m-tile its
// third block an SM).
template <int kLayout, bool kRing = false>
__global__ void __launch_bounds__(bcg_tile::kThreads)
paged_kernel(const __nv_bfloat16* __restrict__ q,
             const typename bcg_tile::KVChunk<kLayout>::Elem* __restrict__ k,
             const typename bcg_tile::KVChunk<kLayout>::Elem* __restrict__ v,
             const typename bcg_tile::KVChunk<kLayout>::Scale* __restrict__ k_scale,
             const typename bcg_tile::KVChunk<kLayout>::Scale* __restrict__ v_scale,
             const int* __restrict__ tbl, const uint8_t* __restrict__ mask,
             __nv_bfloat16* __restrict__ out, int nblk, int bs, int H, int Hkv, int Kq, int Mk,
             long long blk_stride, long long h_stride, long long s_stride,
             long long sc_blk_stride, long long sc_h_stride, float scale,
             const bcg_tile::SplitS split) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* tbl_s = reinterpret_cast<int*>(smem + bcg_tile::launch_smem(Kq * (H / Hkv), Mk, kLayout));
  const int hk = blockIdx.x, b = blockIdx.y;
  const int S = nblk * bs;
  // This split's blocks [blk0, blk0 + nb): its first position falls on a
  // block boundary (split.len is a multiple of bs) and S = nblk * bs.
  const bcg_tile::SplitRange range = bcg_tile::split_range(S, split);
  const int blk0 = range.begin / bs, nb = (range.end - range.begin) / bs;
  const int* row = tbl + (long long)b * nblk + blk0;
  for (int i = threadIdx.x; i < nb; i += bcg_tile::kThreads) tbl_s[i] = row[i];
  __syncthreads();
  const bcg_tile::PagedAddr addr{tbl_s, blk0, bs, blk_stride, (long long)hk * h_stride,
                                 s_stride, sc_blk_stride, (long long)hk * sc_h_stride};
  bcg_tile::decode_tile_body<kLayout, kRing>(q, k, v, k_scale, v_scale, mask, out, S, H, Hkv,
                                             Kq, Mk, addr, scale, /*mask_div=*/0, split);
}

// Table entries of the longest split (the last may run past split_len).
int table_range(int nblk, int bs, int n_split, int split_len) {
  if (n_split <= 1) return nblk;
  const int S = nblk * bs, last = S - (n_split - 1) * split_len;
  return (last > split_len ? last : split_len) / bs;
}

template <int kLayout>
size_t smem_for(int rows, int Mk, int nblk, int bs, int n_split, int split_len) {
  return bcg_tile::launch_smem(rows, Mk, kLayout) +
         (size_t)table_range(nblk, bs, n_split, split_len) * sizeof(int);
}

// The attribute persists: set it once per kernel, to the most dynamic
// shared memory a block may take on this device beside the kernel's
// static shared memory (a launch past it fails at launch).
template <int kLayout, bool kRing>
cudaError_t set_smem() {
  static bool done = false;
  if (done) return cudaSuccess;
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, paged_kernel<kLayout, kRing>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(paged_kernel<kLayout, kRing>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - (int)attr.sharedSizeBytes);
  done = err == cudaSuccess;
  return err;
}

template <int kLayout, bool kRing = false>
int occupancy(int rows, int Mk, int nblk, int bs, int n_split, int split_len, int* blocks) {
  cudaError_t err = set_smem<kLayout, kRing>();
  if (err != cudaSuccess) return (int)err;
  return bcg_tile::occupancy(paged_kernel<kLayout, kRing>,
                             smem_for<kLayout>(rows, Mk, nblk, bs, n_split, split_len), blocks);
}

template <int kLayout, bool kRing = false>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* tbl, const void* mask, void* out, int B, int nblk,
           int bs, int H, int Hkv, int Kq, int Mk, long long blk_stride, long long h_stride,
           long long s_stride, long long sc_blk_stride, long long sc_h_stride, float scale,
           int n_split, int split_len, void* part, void* count, cudaStream_t stream) {
  using Chunk = bcg_tile::KVChunk<kLayout>;
  cudaError_t err = set_smem<kLayout, kRing>();
  if (err != cudaSuccess) return (int)err;
  bcg_tile::SplitS split;
  if (n_split > 1) {
    split.len = split_len;
    split.part = static_cast<float*>(part);
    split.count = static_cast<unsigned*>(count);
  } else {
    n_split = 1;
  }
  dim3 grid(Hkv, B, n_split);
  const size_t smem = smem_for<kLayout>(Kq * (H / Hkv), Mk, nblk, bs, n_split, split_len);
  paged_kernel<kLayout, kRing><<<grid, bcg_tile::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const typename Chunk::Elem*>(k),
      static_cast<const typename Chunk::Elem*>(v),
      static_cast<const typename Chunk::Scale*>(k_scale),
      static_cast<const typename Chunk::Scale*>(v_scale), static_cast<const int*>(tbl),
      static_cast<const uint8_t*>(mask), static_cast<__nv_bfloat16*>(out), nblk, bs, H, Hkv, Kq,
      Mk, blk_stride, h_stride, s_stride, sc_blk_stride, sc_h_stride, scale, split);
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks of the kernel for `layout` resident on one SM at R = rows query
// rows, Mk mask rows and the table range of this plan (the split plan's
// occupancy), written to *blocks.
extern "C" int bcg_paged_attention_occupancy(int layout, int rows, int Mk, int nblk, int bs,
                                             int n_split, int split_len, int* blocks) {
  switch (layout) {
    case bcg_tile::kBf16:
      return rows > 16
                 ? occupancy<bcg_tile::kBf16, true>(rows, Mk, nblk, bs, n_split, split_len, blocks)
                 : occupancy<bcg_tile::kBf16>(rows, Mk, nblk, bs, n_split, split_len, blocks);
    case bcg_tile::kInt8:
      return occupancy<bcg_tile::kInt8>(rows, Mk, nblk, bs, n_split, split_len, blocks);
    case bcg_tile::kInt4:
      return occupancy<bcg_tile::kInt4>(rows, Mk, nblk, bs, n_split, split_len, blocks);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// layout: 0 bf16, 1 int8, 2 packed int4 (bcg_tile::Layout).  Strides are
// in storage elements: blk/h/s of the value pool, blk/h of the scales
// (positions contiguous).  n_split == 1: no workspace (part and count may
// be null); otherwise split_len is a multiple of lcm(128, bs), part holds
// B * Hkv * n_split * Kq * G * (Dh + 2) floats and count B * Hkv unsigned
// ints, all 0 (the kernel leaves them 0 again).
extern "C" int bcg_paged_attention(const void* q, const void* k, const void* v,
                                   const void* k_scale, const void* v_scale, const void* tbl,
                                   const void* mask, void* out, int B, int nblk, int bs, int H,
                                   int Hkv, int Kq, int Mk, int layout, long long blk_stride,
                                   long long h_stride, long long s_stride,
                                   long long sc_blk_stride, long long sc_h_stride, float scale,
                                   int n_split, int split_len, void* part, void* count,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (layout) {
    case bcg_tile::kBf16:
      if (Kq * (H / Hkv) > 16)
        return launch<bcg_tile::kBf16, true>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk,
                                             bs, H, Hkv, Kq, Mk, blk_stride, h_stride, s_stride,
                                             sc_blk_stride, sc_h_stride, scale, n_split,
                                             split_len, part, count, st);
      return launch<bcg_tile::kBf16>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, n_split, split_len, part, count, st);
    case bcg_tile::kInt8:
      return launch<bcg_tile::kInt8>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, n_split, split_len, part, count, st);
    case bcg_tile::kInt4:
      return launch<bcg_tile::kInt4>(q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H,
                                     Hkv, Kq, Mk, blk_stride, h_stride, s_stride, sc_blk_stride,
                                     sc_h_stride, scale, n_split, split_len, part, count, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
