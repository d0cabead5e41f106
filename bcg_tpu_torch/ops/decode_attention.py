"""Decode attention over the KV cache: the kernels' wrappers, their plain
versions and the int8 cache quantizers.

Port of ``bcg_tpu/ops/decode_attention.py``.  Four forms, each a wrapper
with its own launch count, a ``*_cuda`` launcher and a ``*_plain``
version (a CPU tensor runs the plain version; a CUDA tensor launches the
kernel or raises):

* :func:`decode_attention` — one step over the bf16 cache
  (``csrc/decode_attention.cu``, the shared tile body with the window
  split over S: :func:`decode_split_plan` chooses the split, the
  wrapper keeps the kernel's workspace, and
  :func:`decode_attention_split_plain` repeats the split arithmetic for
  the tests).  q ``[B, H, Dh]``; k/v ``[B, S, Hkv, Dh]`` (the cache
  layout, S-major); mask ``[B, S]`` (attendable slots, shared by every
  query row) or ``[B, M, S]`` with ``M`` = 1 or the GQA group (query row
  g of a kv head reads mask row g).  Returns ``[B, H, Dh]``.
* :func:`chunk_decode_attention` — a chunk of K positions over the bf16
  cache (``csrc/chunk_decode_attention.cu``, the window split over S as
  B3a's: :func:`chunk_split_plan`): q ``[B, K, H, Dh]``, mask ``[B, K,
  S]``; returns ``[B, K, H, Dh]``.
* :func:`decode_attention_int8` / :func:`chunk_decode_attention_int8` —
  the same two over the int8 cache (``csrc/decode_attention_int8.cu``,
  the window split over S as B3a's): k/v int8 ``[B, Hkv, S, Dh]`` with
  f32 per-(position, kv head) scales ``[B, Hkv, S]`` (:func:`quantize_kv`).

Every split launcher (these and the paged kernel,
:mod:`bcg_tpu_torch.ops.paged_attention`) shares one planner
(:func:`decode_split_plan`, at the kernel's own occupancy), one
workspace per device (:class:`SplitWorkspace`) and one plain version of
the split arithmetic (:func:`decode_attention_split_plain`).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from bcg_tpu_torch.obs import compile as obs_compile
from bcg_tpu_torch.ops import _build
from bcg_tpu_torch.ops.attention import _NEG_INF, flash_attention_plain

MAX_TILE_ROWS = 64   # K * group query rows per kv head (csrc decode_tile.cuh kMaxRows)
SPLIT_ITER = 128   # positions of one tile-body iteration (csrc decode_tile.cuh kSuper)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, mask, out, B, S, H, Hkv, M, kv batch stride, kv seq stride, scale,
# n_split, split_len, partials, counters, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, ctypes.c_float, _I, _I,
             _P, _P, _P]
# layout, rows, mask rows, table blocks, block size, n_split, split_len ->
# blocks per SM (the dense kernels take only rows and mask rows)
_OCC_ARGTYPES = [_I] * 7 + [ctypes.POINTER(ctypes.c_int)]
# q, k, v, mask, out, B, S, H, Hkv, Kq, Mk, kv batch/head/seq strides, scale,
# n_split, split_len, partials, counters, stream
_CHUNK_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                   ctypes.c_float, _I, _I, _P, _P, _P]
# q, k, v, k_scale, v_scale, mask, out, B, S, H, Hkv, Kq, Mk,
# kv batch/head/seq strides, scale batch/head strides, scale, n_split,
# split_len, partials, counters, stream
_INT8_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                  _LL, _LL, ctypes.c_float, _I, _I, _P, _P, _P]


# ----------------------------------------------------------- kv quantization

def quantize_kv(x, dim: int = -1):
    """bf16/f32 ``[..., Dh]`` -> (int8 values, f32 per-row scale).

    Symmetric absmax over the head dim: ``scale = absmax / 127`` (1.0 for
    an all-zero row), values ``round(x / scale)`` clipped to [-127, 127].
    ``torch.round`` rounds half to even, as ``jnp.round`` does, so the
    bits equal the JAX package's."""
    x32 = x.float()
    absmax = x32.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 127.0)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(dim)


def dequantize_kv(q, scale, dim: int = -1):
    return q.float() * scale.unsqueeze(dim)


def _dequant_heads(x, scale, dtype):
    """int8 ``[B, Hkv, S, Dh]`` + scales -> ``[B, S, Hkv, Dh]`` (a view) in
    ``dtype``: dequantized in f32 and rounded to ``dtype`` at once, as the
    TPU kernel rounds to q's type before both products."""
    return dequantize_kv(x, scale).to(dtype).transpose(1, 2)


def _mask3(mask):
    return mask[:, None, :] if mask.dim() == 2 else mask


def decode_attention_plain(q, k, v, mask, scale):
    """The plain PyTorch version: the decode step as T = 1 masked softmax
    attention over the whole cache, at the kernel's precision
    (:func:`~bcg_tpu_torch.ops.attention.flash_attention_plain`)."""
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    m3 = _mask3(mask)
    if m3.shape[1] == 1:
        return flash_attention_plain(q[:, None], k, v, m3, scale)[:, 0]
    # One mask row per query head of each kv head: attend per row.
    group = H // Hkv
    qg = q.reshape(B, Hkv, group, Dh)
    outs = []
    for g in range(group):
        o = flash_attention_plain(qg[:, :, g][:, None], k, v, m3[:, g][:, None, :], scale)
        outs.append(o[:, 0])
    return torch.stack(outs, dim=2).reshape(B, H, Dh)


def decode_split_plan(B: int, Hkv: int, S: int, sm_count: int, blocks_per_sm: int = 2,
                      block_size: int = 1, max_len: int = 0):
    """How a split kernel cuts the window: ``(n_split, split_len)``.

    The kernel runs ``B * Hkv * n_split`` blocks; split ``z`` covers
    positions ``[z * split_len, (z + 1) * split_len)``, the last one
    ``[(n_split - 1) * split_len, S)``.  ``split_len`` is a whole number
    of units of ``lcm(128, block_size)`` positions: of the tile body's
    128-position iterations, and for a paged pool of its blocks, so that
    every split starts on a block boundary (``block_size`` dividing 128
    leaves the unit at 128).  The plan aims for one wave of
    ``blocks_per_sm`` (the kernel's occupancy, at least 2) blocks on each
    of ``sm_count`` SMs; where ``B * Hkv`` already reaches two blocks per
    SM it plans one split.  No split is shorter than one iteration: a
    last split that would be is folded into the one before (which then
    runs past ``split_len``).  ``max_len`` > 0 caps ``split_len`` (the
    paged kernel stages a split's range of the block table in shared
    memory)."""
    unit = math.lcm(SPLIT_ITER, block_size)
    units = max(1, -(-S // unit))
    cap = max(1, max_len // unit) if max_len else units   # most units in one split
    pairs = B * Hkv
    if pairs >= 2 * sm_count and units <= cap:
        return 1, units * unit
    n = max(1, min(units, max(2, blocks_per_sm) * sm_count // pairs), -(-units // cap))
    per = -(-units // n) * unit
    n = -(-S // per)
    if n > 1 and S - (n - 1) * per < SPLIT_ITER:
        n -= 1
    return (n, per) if n > 1 else (1, units * unit)


def decode_attention_split_plain(q, k, v, mask, scale, n_split, split_len=None,
                                 k_scale=None, v_scale=None):
    """Plain version of the split kernels' arithmetic (flash-decoding):
    the window cut into ``n_split`` contiguous ranges of ``split_len``
    positions (default ``ceil(S / n_split)``; the last range takes the
    rest), each range's running max ``m``, sum ``l`` over the unrounded
    ``p = exp(s - m) * mask`` and unnormalised ``acc`` with ``p`` rounded
    to v's type for the p.v product, relative to the range's own max, as
    the kernels round it; then the merge of the JAX package's
    ``sp_chunk_decode_attention``: global max, each range weighted by
    ``exp(m_z - m)`` (exactly 0 for a range with no live position),
    ``out = acc / l`` (0 for a fully masked row).

    One step: q ``[B, H, Dh]``, mask ``[B, S]`` or ``[B, M, S]`` (M = 1,
    or the group: query row g of a kv head reads mask row g, B3a's form);
    returns ``[B, H, Dh]``.  A chunk: q ``[B, K, H, Dh]``, mask ``[B, S]``
    or ``[B, 1 | K, S]`` (position k reads row k); returns ``[B, K, H,
    Dh]``.  k/v ``[B, S, Hkv, Dh]``, or with ``k_scale``/``v_scale`` the
    int8 cache ``[B, Hkv, S, Dh]`` with f32 scales ``[B, Hkv, S]``,
    dequantized as the int8 kernel does (f32 times the scale, rounded to
    q's type).  Used by the tests and ``chip_smoke.py``, never on the
    served path."""
    if k_scale is not None:
        k = _dequant_heads(k, k_scale, q.dtype)
        v = _dequant_heads(v, v_scale, q.dtype)
    step = q.dim() == 3
    q4 = q[:, None] if step else q
    B, Kq, H, Dh = q4.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    m3 = _mask3(mask)
    # live broadcasts to [B, Kq, Hkv, G, S].
    live = m3[:, None, None] if step and m3.shape[1] == group else m3[:, :, None, None]
    per = split_len or -(-S // n_split)
    qg = q4.float().reshape(B, Kq, Hkv, group, Dh)
    scores = torch.einsum("bkhgd,bshd->bkhgs", qg, k.float()) * scale
    scores = torch.where(live, scores, _NEG_INF)
    ms, ls, accs = [], [], []
    for z in range(n_split):
        a, e = z * per, (S if z == n_split - 1 else min((z + 1) * per, S))
        sz, lz = scores[..., a:e], live[..., a:e]
        m = sz.amax(dim=-1, keepdim=True) if e > a else torch.full_like(scores[..., :1], _NEG_INF)
        p = torch.exp(sz - m) * lz
        ms.append(m[..., 0])
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkhgs,bshd->bkhgd", p.to(v.dtype).float(), v[:, a:e].float()))
    m_all = torch.stack(ms)                                   # [n, B, Kq, Hkv, G]
    l_all = torch.stack(ls)
    m = m_all.amax(dim=0)
    w = torch.where(l_all > 0, torch.exp(m_all - m), torch.zeros_like(m_all))
    l = (w * l_all).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    out = (acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]).reshape(B, Kq, H, Dh)
    out = out.to(v.dtype)
    return out[:, 0] if step else out


def _check(q, k, v, m3):
    B, H, Dh = q.shape
    if Dh != 128:
        raise ValueError(f"decode_attention kernel takes head_dim 128, got {Dh}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"decode_attention kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not q.is_contiguous():
        raise ValueError("decode_attention kernel takes a contiguous q [B, H, Dh]")
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh or H % Hkv:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    group = H // Hkv
    if group > MAX_TILE_ROWS:   # B3a's rows are the group's query heads
        raise ValueError(f"decode_attention kernel takes GQA groups up to {MAX_TILE_ROWS}, "
                         f"got {group}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != Dh \
            or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError(f"decode_attention kernel takes k/v with heads-then-dims "
                         f"contiguous and 16-byte aligned rows, got strides {k.stride()}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention kernel takes 16-byte aligned tensors")
    if m3.dtype != torch.bool or m3.shape[0] != B or m3.shape[2] != S \
            or m3.shape[1] not in (1, group):
        raise ValueError(f"decode_attention kernel takes a bool mask [B, S] or "
                         f"[B, 1|{group}, S], got {m3.dtype} {tuple(m3.shape)}")
    if not (q.device == k.device == v.device == m3.device):
        raise ValueError("decode_attention: tensors on different devices")


class SplitWorkspace:
    """A split kernel's workspace on one device: f32 partials and arrival
    counters, the counters zeroed once when made.  One workspace serves
    every split-S launcher (B3a, B3a-chunk, the int8 forms, the paged
    forms), another B5's split contraction: the calls of each run in
    order on one stream, and each kernel leaves the counters 0, so the
    buffers are reused by every call.  They grow when a call needs more,
    never inside a CUDA graph capture (a capture needs them large enough
    beforehand: one call of the same shape outside it); the buffers a
    growth replaces stay allocated, so a graph captured over them stays
    valid.  ``name`` names the kernels in the capture error."""

    def __init__(self, name: str = "decode attention"):
        self.name = name
        self.part = self.count = None
        self.retired = []

    def get(self, device, n_part: int, n_count: int):
        small = (self.part is None or self.part.numel() < n_part
                 or self.count.numel() < n_count)
        if small:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{self.name}: the split workspace is too small for this "
                                   "call inside a CUDA graph capture; call it once at this "
                                   "shape before capturing")
            if self.part is not None:
                self.retired.append((self.part, self.count))
            n_part = max(n_part, 1 if self.part is None else self.part.numel())
            n_count = max(n_count, 1 if self.count is None else self.count.numel())
            with obs_compile.time_block("split_workspace"):
                self.part = torch.empty(n_part, dtype=torch.float32, device=device)
                self.count = torch.zeros(n_count, dtype=torch.int32, device=device)
            obs_compile.note_shape("split_workspace", (n_part, n_count),
                                   names=("partials", "counters"), timing="stash")
        return self.part, self.count


_workspaces = {}


def split_buffers(q, Hkv: int, n_split: int, rows: int):
    """Pointers to the partials and counters of a split launch on q's
    device with ``rows`` query rows per kv head (0, 0 for one split):
    ``B * Hkv * n_split * rows * (Dh + 2)`` floats and ``B * Hkv``
    counters."""
    if n_split == 1:
        return 0, 0
    B, Dh = q.shape[0], q.shape[-1]
    ws = _workspaces.get(q.device)
    if ws is None:
        ws = _workspaces[q.device] = SplitWorkspace()
    part, count = ws.get(q.device, B * Hkv * n_split * rows * (Dh + 2), B * Hkv)
    return part.data_ptr(), count.data_ptr()


@functools.lru_cache(maxsize=1024)
def _plan(kernel: str, layout: int, dev: int, B: int, Hkv: int, S: int, rows: int, M: int,
          bs: int = 0, max_len: int = 0):
    """:func:`decode_split_plan` on device ``dev`` for the split kernel of
    library ``kernel``, from the SM count and the kernel's occupancy
    (``bcg_<kernel>_occupancy``) at this many query and mask rows.  A
    paged kernel (block size ``bs``) also stages its split's range of the
    table, so its occupancy is taken again at the first plan's range."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fn = _build.entry(kernel, f"bcg_{kernel}_occupancy", _OCC_ARGTYPES)

    def plan(n_split=1, split_len=0):
        occ = ctypes.c_int(0)
        _build.check(fn(layout, rows, M, S // bs if bs else 0, bs, n_split, split_len,
                        ctypes.byref(occ)), f"{kernel} occupancy")
        return decode_split_plan(B, Hkv, S, sms, occ.value, bs or 1, max_len)

    first = plan()
    return plan(*first) if bs else first


def _split_for(q, Hkv, S, M, kernel="decode_attention", plan=None):
    """The split plan of a call with q ``[B, H, Dh]`` (one step) or ``[B,
    Kq, H, Dh]`` on a CUDA device: rows = Kq times the group, ``M`` mask
    rows (B3a's kernel by default).  ``plan``: the ``(batch, kv heads)``
    to plan the split for, where not the call's own — a mesh rank plans
    its rows and heads as the whole batch's, so its splits, and so its
    outputs, are one device's bit for bit (the split count moves a
    bf16 decode step's output by more than the sums' order does)."""
    Kq = q.shape[1] if q.dim() == 4 else 1
    B, Hp = plan if plan is not None else (q.shape[0], Hkv)
    return _plan(kernel, 0, q.device.index, B, Hp, S, Kq * (q.shape[-2] // Hkv), M)


def decode_attention_cuda(q, k, v, mask, scale, plan=None):
    """Launch ``csrc/decode_attention.cu`` on the current stream: one
    launch, the window split as :func:`decode_split_plan` says (for the
    ``plan`` shape where given, :func:`_split_for`)."""
    B, H, Dh = q.shape
    m3 = _mask3(mask)
    _check(q, k, v, m3)
    m3 = m3.contiguous()
    fn = _build.entry("decode_attention", "bcg_decode_attention", _ARGTYPES)
    S, Hkv = k.shape[1], k.shape[2]
    M = m3.shape[1]
    n_split, split_len = _split_for(q, Hkv, S, M, plan=plan)
    part_ptr, count_ptr = split_buffers(q, Hkv, n_split, H // Hkv)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m3.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, M, k.stride(0), k.stride(1), float(scale), n_split, split_len,
             part_ptr, count_ptr, _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, mask, scale, plan=None):
    """Decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``plan``: :func:`_split_for`'s)."""
    decode_attention.calls += 1
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, scale)
    return decode_attention_cuda(q, k, v, mask, scale, plan)


decode_attention.launches = 0
decode_attention.calls = 0


# ------------------------------------------------------ chunk and int8 forms

def chunk_decode_attention_plain(q, k, v, mask, scale):
    """Plain version of the bf16 chunk form: ``[B, K]`` query positions
    over the whole cache with a ``[B, K, S]`` mask, at the kernel's
    precision (:func:`~bcg_tpu_torch.ops.attention.flash_attention_plain`)."""
    return flash_attention_plain(q, k, v, mask, scale)


def decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale):
    """Plain version of the int8 single step: dequantize (f32, then q's
    type), then the step's masked attention."""
    kd = _dequant_heads(k, k_scale, q.dtype)
    vd = _dequant_heads(v, v_scale, q.dtype)
    return flash_attention_plain(q[:, None], kd, vd, _mask3(mask), scale)[:, 0]


def chunk_decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale):
    """Plain version of the int8 chunk form."""
    kd = _dequant_heads(k, k_scale, q.dtype)
    vd = _dequant_heads(v, v_scale, q.dtype)
    return flash_attention_plain(q, kd, vd, mask, scale)


def check_tile_operands(name, q, k, v, mask, S, Hkv, kv_dtype, dh_store):
    """Checks that every launcher of the shared tile kernel
    (``csrc/decode_tile.cuh``, dense or paged) makes: q ``[B, Kq, H,
    Dh]`` contiguous bf16, head dim 128, ``Kq * group`` rows at most
    :data:`MAX_TILE_ROWS`, k/v of ``kv_dtype`` and one layout, stored
    rows of ``dh_store`` elements 16-byte aligned, a bool mask ``[B, 1 |
    Kq, S]`` (or ``[B, S]``, one row), one device."""
    B, Kq, H, Dh = q.shape
    if Dh != 128:
        raise ValueError(f"{name} kernel takes head_dim 128, got {Dh}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise TypeError(f"{name} kernel takes a contiguous bf16 q, got {q.dtype}")
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{name} kernel takes {kv_dtype} k/v, got {k.dtype}/{v.dtype}")
    if H % Hkv or Kq * (H // Hkv) > MAX_TILE_ROWS:
        raise ValueError(f"{name} kernel takes up to {MAX_TILE_ROWS} query rows per kv "
                         f"head, got {Kq} x {H // max(Hkv, 1)}")
    align = 16 // k.element_size()
    kst, kshape = k.stride(), k.shape
    if kshape != v.shape or kst != v.stride() or kst[3] != 1 or kshape[3] != dh_store \
            or kst[0] % align or kst[1] % align or kst[2] % align:
        raise ValueError(f"{name} kernel takes k/v {tuple(kshape)} of one layout with "
                         f"16-byte aligned rows, got strides {kst}/{v.stride()}")
    mshape = mask.shape
    if len(mshape) == 2:                    # [B, S]: one row for every query row
        mshape = (mshape[0], 1, mshape[1])
    if mask.dtype != torch.bool or len(mshape) != 3 or mshape[0] != B \
            or mshape[2] != S or mshape[1] not in (1, Kq):
        raise ValueError(f"{name} kernel takes a bool mask [B, 1|{Kq}, {S}], got "
                         f"{mask.dtype} {tuple(mshape)}")
    dev = q.device
    if k.device != dev or v.device != dev or mask.device != dev:
        raise ValueError(f"{name}: tensors on different devices")
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError(f"{name} kernel takes 16-byte aligned q/k/v")


def _check_tile(q, k, v, mask, S, Hkv, int8, scales=()):
    """The dense tile launchers' checks: :func:`check_tile_operands`, k/v
    ``[B, S, Hkv, Dh]`` (bf16) or ``[B, Hkv, S, Dh]`` (int8) and the int8
    form's f32 scales ``[B, Hkv, S]``."""
    name = "decode_attention_int8" if int8 else "chunk_decode_attention"
    check_tile_operands(name, q, k, v, mask, S, Hkv,
                        torch.int8 if int8 else torch.bfloat16, q.shape[3])
    B = q.shape[0]
    if k.shape[0] != B:
        raise ValueError(f"{name} kernel takes k/v of batch {B}, got {tuple(k.shape)}")
    st0 = scales[0].stride() if scales else None
    for t in scales:
        st = t.stride()
        if t.dtype != torch.float32 or t.shape != (B, Hkv, S) or st[2] != 1 or st != st0 \
                or t.device != q.device:
            raise ValueError(f"{name} kernel takes f32 scales [B, Hkv, S] with positions "
                             f"contiguous, got {t.dtype} {tuple(t.shape)} {t.stride()}")


def chunk_split_plan(q, k, mask, plan=None):
    """``(n_split, split_len)`` of the bf16 chunk kernel's call on these
    wrapper inputs (q ``[B, K, H, Dh]``, k ``[B, S, Hkv, Dh]``, mask
    ``[B, K, S]``; ``plan``: :func:`_split_for`'s)."""
    return _split_for(q, k.shape[2], k.shape[1], _mask3(mask).shape[1],
                      kernel="chunk_decode_attention", plan=plan)


def chunk_decode_attention_cuda(q, k, v, mask, scale, plan=None):
    """Launch ``csrc/chunk_decode_attention.cu`` on the current stream: one
    launch, the window split as :func:`decode_split_plan` says at the
    kernel's occupancy (for the ``plan`` shape where given)."""
    B, Kq, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check_tile(q, k, v, mask, S, Hkv, int8=False)
    mask = mask.contiguous()
    Mk = mask.shape[1] if mask.dim() == 3 else 1
    fn = _build.entry("chunk_decode_attention", "bcg_chunk_decode_attention",
                      _CHUNK_ARGTYPES)
    rows = Kq * (H // Hkv)
    n_split, split_len = _split_for(q, Hkv, S, Mk, kernel="chunk_decode_attention", plan=plan)
    part_ptr, count_ptr = split_buffers(q, Hkv, n_split, rows)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, Kq, Mk, k.stride(0), k.stride(2), k.stride(1),
             float(scale), n_split, split_len, part_ptr, count_ptr, _build.stream_ptr(q))
    _build.check(err, "chunk_decode_attention")
    chunk_decode_attention.launches += 1
    return out


def int8_split_plan(q, k, mask, plan=None):
    """``(n_split, split_len)`` of the int8 kernel's call on these wrapper
    inputs (q ``[B, H, Dh]`` with mask ``[B, S]``, or q ``[B, K, H,
    Dh]`` with mask ``[B, K, S]``; ``plan``: :func:`_split_for`'s)."""
    q4 = q[:, None] if q.dim() == 3 else q
    return _split_for(q4, k.shape[1], k.shape[2], _mask3(mask).shape[1],
                      kernel="decode_attention_int8", plan=plan)


def _int8_launch(q4, k, v, k_scale, v_scale, m3, scale, plan=None):
    """Launch ``csrc/decode_attention_int8.cu``; q4 ``[B, Kq, H, Dh]``,
    m3 ``[B, 1 | Kq, S]`` or ``[B, S]`` (one row)."""
    B, Kq, H, Dh = q4.shape
    Hkv, S = k.shape[1], k.shape[2]
    _check_tile(q4, k, v, m3, S, Hkv, int8=True, scales=(k_scale, v_scale))
    m3 = m3.contiguous()
    Mk = m3.shape[1] if m3.dim() == 3 else 1
    fn = _build.entry("decode_attention_int8", "bcg_decode_attention_int8", _INT8_ARGTYPES)
    rows = Kq * (H // Hkv)
    n_split, split_len = _split_for(q4, Hkv, S, Mk, kernel="decode_attention_int8", plan=plan)
    part_ptr, count_ptr = split_buffers(q4, Hkv, n_split, rows)
    out = torch.empty_like(q4)
    err = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
             v_scale.data_ptr(), m3.data_ptr(), out.data_ptr(), B, S, H, Hkv, Kq,
             Mk, k.stride(0), k.stride(1), k.stride(2), k_scale.stride(0),
             k_scale.stride(1), float(scale), n_split, split_len, part_ptr, count_ptr,
             _build.stream_ptr(q4))
    _build.check(err, "decode_attention_int8")
    return out


def decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale, plan=None):
    """Launch ``csrc/decode_attention_int8.cu`` for one step (rows = the
    GQA group, one mask row shared by all of them)."""
    if mask.dim() != 2:
        raise ValueError(f"decode_attention_int8 takes a [B, S] mask, got {tuple(mask.shape)}")
    out = _int8_launch(q[:, None], k, v, k_scale, v_scale, mask, scale, plan)
    decode_attention_int8.launches += 1
    return out[:, 0]


def chunk_decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale, plan=None):
    """Launch ``csrc/decode_attention_int8.cu`` for a chunk (rows = K x
    the GQA group, mask ``[B, K, S]``)."""
    out = _int8_launch(q, k, v, k_scale, v_scale, mask, scale, plan)
    chunk_decode_attention_int8.launches += 1
    return out


def chunk_decode_attention(q, k, v, mask, scale, plan=None):
    """bf16 chunk decode attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors (``plan``: :func:`_split_for`'s)."""
    chunk_decode_attention.calls += 1
    if q.device.type == "cpu":
        return chunk_decode_attention_plain(q, k, v, mask, scale)
    return chunk_decode_attention_cuda(q, k, v, mask, scale, plan)


def decode_attention_int8(q, k, v, k_scale, v_scale, mask, scale, plan=None):
    """int8-cache decode step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors (``plan``: :func:`_split_for`'s)."""
    decode_attention_int8.calls += 1
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale)
    return decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale, plan)


def chunk_decode_attention_int8(q, k, v, k_scale, v_scale, mask, scale, plan=None):
    """int8-cache chunk decode attention: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors (``plan``:
    :func:`_split_for`'s)."""
    chunk_decode_attention_int8.calls += 1
    if q.device.type == "cpu":
        return chunk_decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale)
    return chunk_decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale, plan)


chunk_decode_attention.launches = 0
chunk_decode_attention.calls = 0
decode_attention_int8.launches = 0
decode_attention_int8.calls = 0
chunk_decode_attention_int8.launches = 0
chunk_decode_attention_int8.calls = 0
