"""Block-paged KV cache: pool init, block-indexed writes and gathers, and
paged decode attention — the port of ``bcg_tpu/ops/paged_attention.py``.

The paged layout replaces the per-row ``[B, S]`` KV slab with ONE pool
of fixed-size blocks per layer plus a per-row block table: logical slot
``s`` of row ``b`` lives at block ``tbl[b, s // bs]``, offset
``s % bs``.  Rows that share a token prefix reference the same blocks
(refcounted by the host-side radix index, :mod:`bcg_tpu_torch.engine.paged_kv`).
Pool layouts, the JAX package's:

* bf16: ``k``/``v`` ``[N, bs, Hkv, Dh]``
* int8: ``k``/``v`` ``[N, Hkv, bs, Dh]`` with f32 scales ``[N, Hkv, bs]``
* int4: ``k``/``v`` ``[N, Hkv, bs, Dh/2]`` packed two per byte with bf16
  scales ``[N, Hkv, bs]`` (the scale dtype marks the layout,
  ``transformer.kv_is_int4``)

A paged cache ENTRY is the pool plus the block table:
``{"k", "v"[, "k_scale", "v_scale"], "tbl": [B, nblk] int32}``; every
layer's entry shares one table tensor.  Block 0 is the null block: table
padding points at it, it is never written, and every slot it backs is
masked out of attention.  Writes go IN PLACE (the JAX version returns a
new pool).

Two attention forms, each a wrapper with per-layout launch counts, a
``*_cuda`` launcher (``csrc/paged_attention.cu``, one source for all
three layouts and both forms, the window split over S: :func:`split_plan`)
and a ``*_plain`` version — the gather oracle: :func:`paged_gather_entry`,
dequantize, then the dense plain attention, so paged output is
bit-identical to the dense plain path given the same block contents.  A
CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  The plain versions count their calls (``.calls``), so a run on
the card can show it never took them.  :func:`paged_attention_split_plain`
repeats the kernel's split arithmetic for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple

import torch

from bcg_tpu_torch.ops import _build
from bcg_tpu_torch.ops.decode_attention import (
    SPLIT_ITER,
    _plan,
    check_tile_operands,
    chunk_decode_attention_plain,
    decode_attention_plain,
    decode_attention_split_plain,
    split_buffers,
)

LAYOUTS = ("bf16", "int8", "int4")   # csrc bcg_tile::Layout order
# Most table entries a split stages in shared memory (16 KB): caps a
# split's positions (decode_split_plan's max_len), so no table is too
# wide to stage.
MAX_SPLIT_BLOCKS = 4096
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, k_scale, v_scale, tbl, mask, out, B, nblk, bs, H, Hkv, Kq, Mk,
# layout, blk/h/s strides, scale blk/h strides, scale, n_split, split_len,
# partials, counters, stream
_ARGTYPES = [_P] * 8 + [_I] * 8 + [_LL] * 5 + [ctypes.c_float, _I, _I, _P, _P, _P]


def is_paged(entry: Dict) -> bool:
    """True for a paged cache entry (carries a block table)."""
    return "tbl" in entry


def block_size(entry: Dict) -> int:
    """Tokens per block, read off the pool's layout."""
    return entry["k"].shape[2 if "k_scale" in entry else 1]


def num_kv_heads(entry: Dict) -> int:
    """Kv-head count, read off the pool's layout."""
    return entry["k"].shape[1 if "k_scale" in entry else 2]


def layout(entry: Dict) -> str:
    """``"bf16"``, ``"int8"`` or ``"int4"`` (bf16 scales mark int4)."""
    if "k_scale" not in entry:
        return "bf16"
    return "int4" if entry["k_scale"].dtype == torch.bfloat16 else "int8"


def init_block_pool(spec, num_blocks: int, block_size: int, quantized=False,
                    device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Zero-filled per-layer block pool (no tables yet): a list of entry
    dicts, all views of one buffer per kind.  ``quantized`` is False,
    True / ``"int8"`` or ``"int4"``.  Block 0 is the null block by
    convention (the allocator never hands it out)."""
    L, Dh = spec.num_layers, spec.head_dim
    # Under a mesh the rank's kv heads (``parallel.sharding.paged_pool_layout``:
    # heads over tp, blocks and table replicated).
    par = getattr(spec, "par", None)
    Hkv = par.kv_heads if par is not None else spec.num_kv_heads
    if quantized == "int4":
        from bcg_tpu_torch.models.quantize import kv_int4_layout

        dh_store, scale_dtype = kv_int4_layout(Dh)
    else:
        dh_store, scale_dtype = Dh, torch.float32
    if quantized:
        buf = torch.zeros((L, 2, num_blocks, Hkv, block_size, dh_store), dtype=torch.int8,
                          device=device)
        scales = torch.ones((L, 2, num_blocks, Hkv, block_size), dtype=scale_dtype,
                            device=device)
        return [{"k": buf[li, 0], "v": buf[li, 1], "k_scale": scales[li, 0],
                 "v_scale": scales[li, 1]} for li in range(L)]
    buf = torch.zeros((L, 2, num_blocks, block_size, Hkv, Dh), dtype=torch.bfloat16,
                      device=device)
    return [{"k": buf[li, 0], "v": buf[li, 1]} for li in range(L)]


class WriteIndex(NamedTuple):
    """Where a ``[B, T]`` write lands: pool block and offset, ``[B, T]``
    each.  Every layer shares the table, so a forward pass computes it
    once (:func:`write_index`) and hands it to each layer's write."""
    blk: torch.Tensor
    off: torch.Tensor


def write_index(entry: Dict, T: int, pos) -> WriteIndex:
    """The :class:`WriteIndex` of a ``[B, T]`` write at logical slots
    ``pos + t`` (``pos`` a Python int, a 0-d tensor or a ``[B]`` tensor
    of per-row slots)."""
    tbl = entry["tbl"]
    B = tbl.shape[0]
    bs = block_size(entry)
    t = torch.arange(T, device=tbl.device)
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        p = pos.long()[:, None] + t[None, :]
    elif isinstance(pos, torch.Tensor):
        p = (pos.long() + t)[None, :].expand(B, T)
    else:
        p = (pos + t)[None, :].expand(B, T)
    blk = torch.gather(tbl.long(), 1, p // bs)
    if blk.device.type == "cpu" and bool((blk == 0).any()):
        # The plain path checks what the device path cannot afford to
        # (a host read per write): the null block stays all zeros.
        raise RuntimeError("paged_write: a write lands on the null block 0")
    return WriteIndex(blk, p % bs)


def paged_write(entry: Dict, k, v, pos) -> Dict:
    """Write fresh ``[B, T, Hkv, Dh]`` k/v through the block table, IN
    PLACE (quantizing for an int8 or int4 pool): row ``b``'s token ``t``
    lands at ``(tbl[b, p // bs], p % bs)`` with ``p = pos(+b) + t``;
    ``pos`` may be a precomputed :class:`WriteIndex`.  Callers guarantee
    that the written range lies in the row's PRIVATE blocks (never a
    radix-shared one, never block 0)."""
    blk, off = pos if isinstance(pos, WriteIndex) else write_index(entry, k.shape[1], pos)
    if "k_scale" in entry:
        from bcg_tpu_torch.models.transformer import _kv_quantizer

        quant = _kv_quantizer(entry)
        kq, ksc = quant(k)     # [B, T, Hkv, Dh(/2)], [B, T, Hkv]
        vq, vsc = quant(v)
        # Pool [N, Hkv, bs, *] / scales [N, Hkv, bs]: the advanced indices
        # on dims (0, 2) move to the front, so the target region is
        # [B, T, Hkv, *] — the fresh layout, as in numpy and JAX.
        entry["k"][blk, :, off] = kq
        entry["v"][blk, :, off] = vq
        entry["k_scale"][blk, :, off] = ksc
        entry["v_scale"][blk, :, off] = vsc
    else:
        entry["k"][blk, off] = k.to(entry["k"].dtype)
        entry["v"][blk, off] = v.to(entry["v"].dtype)
    return entry


def paged_gather_entry(entry: Dict, upto_blocks: int = 0) -> Dict:
    """Dense-layout copy of a paged entry: each row's blocks gathered and
    reshaped to the dense cache layout (bf16 ``[B, S, Hkv, Dh]``; int8 /
    int4 ``[B, Hkv, S, Dh(/2)]`` + ``[B, Hkv, S]`` scales),
    ``S = nblk * bs``.  ``upto_blocks`` limits it to the table's first
    columns (a prefill's history)."""
    tbl = entry["tbl"].long()
    if upto_blocks:
        tbl = tbl[:, :upto_blocks]
    B, nblk = tbl.shape
    S = nblk * block_size(entry)
    if "k_scale" in entry:
        def kv(name):
            g = entry[name][tbl]                   # [B, nblk, Hkv, bs, D]
            return g.transpose(1, 2).reshape(B, g.shape[2], S, g.shape[-1])

        def sc(name):
            g = entry[name][tbl]                   # [B, nblk, Hkv, bs]
            return g.transpose(1, 2).reshape(B, g.shape[2], S)

        return {"k": kv("k"), "v": kv("v"), "k_scale": sc("k_scale"),
                "v_scale": sc("v_scale")}

    def kv(name):
        g = entry[name][tbl]                       # [B, nblk, bs, Hkv, Dh]
        return g.reshape(B, S, g.shape[-2], g.shape[-1])

    return {"k": kv("k"), "v": kv("v")}


def _dense_view(entry: Dict, dtype):
    """Gathered ``[B, S, Hkv, Dh]`` k/v; a quantized pool's dequantized in
    f32, then rounded to ``dtype``, as the kernel does (a bf16 pool keeps
    its type, as the dense plain path does)."""
    dense = paged_gather_entry(entry)
    if "k_scale" not in dense:
        return dense["k"], dense["v"]
    from bcg_tpu_torch.models.transformer import _dequant_view

    return _dequant_view(dense, dtype)


# ------------------------------------------------------------------- plain

def paged_decode_attention_plain(q, entry: Dict, mask, scale):
    """Gather oracle of the single step: q ``[B, 1, H, Dh]``, mask
    ``[B, S]``; returns ``[B, 1, H, Dh]``."""
    paged_decode_attention_plain.calls += 1
    k, v = _dense_view(entry, q.dtype)
    return decode_attention_plain(q[:, 0], k, v, mask, scale)[:, None]


def paged_chunk_attention_plain(q, entry: Dict, mask, scale):
    """Gather oracle of the chunk form: q ``[B, K, H, Dh]``, mask
    ``[B, K, S]``; returns ``[B, K, H, Dh]``."""
    paged_chunk_attention_plain.calls += 1
    k, v = _dense_view(entry, q.dtype)
    return chunk_decode_attention_plain(q, k, v, mask, scale)


paged_decode_attention_plain.calls = 0
paged_chunk_attention_plain.calls = 0


def paged_attention_split_plain(q, entry: Dict, mask, scale, n_split, split_len=None):
    """Plain version of the kernel's split arithmetic at a plan: the
    gathered dense view (a quantized pool dequantized as the kernel does)
    through :func:`~bcg_tpu_torch.ops.decode_attention.
    decode_attention_split_plain`.  q ``[B, Kq, H, Dh]``, mask ``[B, S]``
    (one step) or ``[B, Kq, S]``; returns ``[B, Kq, H, Dh]``.  Used by
    the tests and ``chip_smoke.py``; not counted in ``.calls``."""
    k, v = _dense_view(entry, q.dtype)
    return decode_attention_split_plain(q, k, v, mask, scale, n_split, split_len)


# -------------------------------------------------------------------- CUDA

def _check(q, entry, mask):
    """The tile's own checks (:func:`~bcg_tpu_torch.ops.decode_attention.
    check_tile_operands`) plus the table's and the scales'.  Returns the
    pool's layout, block size and kv-head count."""
    B, _, _, Dh = q.shape
    lay = layout(entry)
    k, v, tbl = entry["k"], entry["v"], entry["tbl"]
    tshape = tbl.shape
    if tbl.dtype != torch.int32 or len(tshape) != 2 or tshape[0] != B \
            or not tbl.is_contiguous() or tbl.device != q.device:
        raise ValueError(f"paged_attention kernel takes a contiguous int32 table [B, nblk], "
                         f"got {tbl.dtype} {tuple(tshape)}")
    quant = lay != "bf16"
    kshape = k.shape
    bs, Hkv = (kshape[2], kshape[1]) if quant else (kshape[1], kshape[2])
    check_tile_operands("paged_attention", q, k, v, mask, tshape[1] * bs, Hkv,
                        torch.int8 if quant else torch.bfloat16,
                        Dh // 2 if lay == "int4" else Dh)
    if quant:
        st0 = entry["k_scale"].stride()
        for t in (entry["k_scale"], entry["v_scale"]):
            st = t.stride()
            if t.shape != kshape[:3] or st[2] != 1 or st != st0 or t.device != q.device:
                raise ValueError(f"paged_attention kernel takes scales {tuple(kshape[:3])} "
                                 f"with positions contiguous, got {tuple(t.shape)} {st}")
    return lay, bs, Hkv


def _plan_for(q4, lay, bs, Hkv, nblk, Mk, plan=None):
    """The split plan of a call (see :func:`split_plan`); ``plan``: the
    ``(batch, kv heads)`` to plan for where not the call's own (a mesh
    rank plans the whole mesh's, as ``decode_attention._split_for``)."""
    rows = q4.shape[1] * (q4.shape[2] // Hkv)
    B, Hp = plan if plan is not None else (q4.shape[0], Hkv)
    return _plan("paged_attention", LAYOUTS.index(lay), q4.device.index, B, Hp,
                 nblk * bs, rows, Mk, bs, MAX_SPLIT_BLOCKS * bs - SPLIT_ITER)


def split_plan(q4, entry: Dict, m3, plan=None):
    """``(n_split, split_len)`` of the kernel's call with q4 ``[B, Kq, H,
    Dh]`` and a ``[B, 1 | Kq, S]`` mask on a CUDA device: every split a
    whole number of pool blocks, at most :data:`MAX_SPLIT_BLOCKS` of
    them."""
    return _plan_for(q4, layout(entry), block_size(entry), num_kv_heads(entry),
                     entry["tbl"].shape[1], m3.shape[1] if m3.dim() == 3 else 1, plan)


def _launch(q4, entry, m3, scale, plan=None):
    """Launch ``csrc/paged_attention.cu`` on the current stream; q4
    ``[B, Kq, H, Dh]``, m3 ``[B, 1 | Kq, S]`` or ``[B, S]`` (one row).
    Returns the layout."""
    lay, bs, Hkv = _check(q4, entry, m3)
    m3 = m3.contiguous()
    Mk = m3.shape[1] if m3.dim() == 3 else 1
    B, Kq, H, _ = q4.shape
    k, v, tbl = entry["k"], entry["v"], entry["tbl"]
    kst = k.stride()
    if lay == "bf16":            # [N, bs, Hkv, Dh]
        blk_st, h_st, s_st = kst[0], kst[2], kst[1]
        ks_ptr = vs_ptr = 0
        sc_blk = sc_h = 0
    else:                        # [N, Hkv, bs, Dh(/2)] + scales [N, Hkv, bs]
        blk_st, h_st, s_st = kst[0], kst[1], kst[2]
        ks = entry["k_scale"]
        ks_ptr, vs_ptr = ks.data_ptr(), entry["v_scale"].data_ptr()
        sc_blk, sc_h = ks.stride(0), ks.stride(1)
    fn = _build.entry("paged_attention", "bcg_paged_attention", _ARGTYPES)
    nblk = tbl.shape[1]
    n_split, split_len = _plan_for(q4, lay, bs, Hkv, nblk, Mk, plan)
    part_ptr, count_ptr = split_buffers(q4, Hkv, n_split, Kq * (H // Hkv))
    out = torch.empty_like(q4)
    err = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), ks_ptr, vs_ptr, tbl.data_ptr(),
             m3.data_ptr(), out.data_ptr(), B, nblk, bs, H, Hkv, Kq, Mk,
             LAYOUTS.index(lay), blk_st, h_st, s_st, sc_blk, sc_h, float(scale), n_split,
             split_len, part_ptr, count_ptr, _build.stream_ptr(q4))
    _build.check(err, "paged_attention")
    return out, lay


def paged_decode_attention_cuda(q, entry: Dict, mask, scale, plan=None):
    """Launch the kernel for one step (rows = the GQA group, one mask row
    shared by all of them)."""
    if mask.dim() != 2:
        raise ValueError(f"paged_decode_attention takes a [B, S] mask, got {tuple(mask.shape)}")
    out, lay = _launch(q, entry, mask, scale, plan)
    paged_decode_attention.launches[lay] += 1
    return out


def paged_chunk_attention_cuda(q, entry: Dict, mask, scale, plan=None):
    """Launch the kernel for a chunk (rows = K x the GQA group, mask
    ``[B, K, S]``)."""
    out, lay = _launch(q, entry, mask, scale, plan)
    paged_chunk_attention.launches[lay] += 1
    return out


# ---------------------------------------------------------------- wrappers

def paged_decode_attention(q, entry: Dict, mask, scale, plan=None):
    """Single-token decode attention over a paged cache: q ``[B, 1, H,
    Dh]``, mask ``[B, S]`` attendable logical slots; returns ``[B, 1, H,
    Dh]``.  The CUDA kernel for CUDA tensors (``plan``: :func:`_plan_for`'s),
    the gather oracle for CPU tensors."""
    paged_decode_attention.calls += 1
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, entry, mask, scale)
    return paged_decode_attention_cuda(q, entry, mask, scale, plan)


def paged_chunk_attention(q, entry: Dict, mask, scale, plan=None):
    """Chunk decode attention over a paged cache (the fast-forward and
    speculative-verify windows): q ``[B, K, H, Dh]``, mask ``[B, K, S]``;
    returns ``[B, K, H, Dh]``.  The CUDA kernel for CUDA tensors, the
    gather oracle for CPU tensors."""
    paged_chunk_attention.calls += 1
    if q.device.type == "cpu":
        return paged_chunk_attention_plain(q, entry, mask, scale)
    return paged_chunk_attention_cuda(q, entry, mask, scale, plan)


paged_decode_attention.launches = dict.fromkeys(LAYOUTS, 0)
paged_decode_attention.calls = 0
paged_chunk_attention.launches = dict.fromkeys(LAYOUTS, 0)
paged_chunk_attention.calls = 0
