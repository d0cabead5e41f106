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
  cache (``csrc/chunk_decode_attention.cu``): q ``[B, K, H, Dh]``, mask
  ``[B, K, S]``; returns ``[B, K, H, Dh]``.
* :func:`decode_attention_int8` / :func:`chunk_decode_attention_int8` —
  the same two over the int8 cache (``csrc/decode_attention_int8.cu``):
  k/v int8 ``[B, Hkv, S, Dh]`` with f32 per-(position, kv head) scales
  ``[B, Hkv, S]`` (:func:`quantize_kv`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bcg_tpu_torch.ops import _build
from bcg_tpu_torch.ops.attention import _NEG_INF, flash_attention_plain

MAX_TILE_ROWS = 64   # K * group query rows per kv head (csrc decode_tile.cuh kMaxRows)
SPLIT_ITER = 128   # positions of one tile-body iteration (csrc decode_tile.cuh kSuper)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, mask, out, B, S, H, Hkv, M, kv batch stride, kv seq stride, scale,
# n_split, split_len, partials, counters, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, ctypes.c_float, _I, _I,
             _P, _P, _P]
_OCC_ARGTYPES = [_I, _I, _I, ctypes.POINTER(ctypes.c_int)]   # H, Hkv, M -> blocks per SM
# q, k, v, mask, out, B, S, H, Hkv, Kq, Mk, kv batch/head/seq strides, scale, stream
_CHUNK_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                   ctypes.c_float, _P]
# q, k, v, k_scale, v_scale, mask, out, B, S, H, Hkv, Kq, Mk,
# kv batch/head/seq strides, scale batch/head strides, scale, stream
_INT8_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _LL, _LL, _LL,
                  _LL, _LL, ctypes.c_float, _P]


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


def decode_split_plan(B: int, Hkv: int, S: int, sm_count: int, blocks_per_sm: int = 2):
    """How B3a cuts the window: ``(n_split, split_len)``.

    The kernel runs ``B * Hkv * n_split`` blocks; split ``z`` covers
    positions ``[z * split_len, (z + 1) * split_len)``, the last one
    ``[(n_split - 1) * split_len, S)``.  ``split_len`` is a whole number
    of the tile body's 128-position iterations.  The plan aims for one
    wave of ``blocks_per_sm`` (the kernel's occupancy, at least 2) blocks
    on each of ``sm_count`` SMs; where ``B * Hkv`` already reaches two
    blocks per SM it plans one split.  No split is shorter than one
    iteration: a last split that would be is folded into the one before
    (which then runs past ``split_len``)."""
    iters = max(1, -(-S // SPLIT_ITER))
    pairs = B * Hkv
    if pairs >= 2 * sm_count:
        return 1, iters * SPLIT_ITER
    n = max(1, min(iters, max(2, blocks_per_sm) * sm_count // pairs))
    per = -(-iters // n) * SPLIT_ITER
    n = -(-S // per)
    if n > 1 and S - (n - 1) * per < SPLIT_ITER:
        n -= 1
    return (n, per) if n > 1 else (1, iters * SPLIT_ITER)


def decode_attention_split_plain(q, k, v, mask, scale, n_split, split_len=None):
    """Plain version of B3a's split arithmetic (flash-decoding): the
    window cut into ``n_split`` contiguous ranges of ``split_len``
    positions (default ``ceil(S / n_split)``; the last range takes the
    rest), each range's running max ``m``, sum ``l`` over the unrounded
    ``p = exp(s - m) * mask`` and unnormalised ``acc`` with ``p`` rounded
    to v's type for the p.v product, relative to the range's own max, as
    the kernel rounds it; then the merge of the JAX package's
    ``sp_chunk_decode_attention``: global max, each range weighted by
    ``exp(m_z - m)`` (exactly 0 for a range with no live position),
    ``out = acc / l`` (0 for a fully masked row).  Used by the tests and
    ``chip_smoke.py``, never on the served path."""
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    group = H // Hkv
    per = split_len or -(-S // n_split)
    m3 = _mask3(mask)
    live = m3[:, None] if m3.shape[1] == 1 else m3.reshape(B, 1, group, S)   # [B, 1, G|1, S]
    qg = q.float().reshape(B, Hkv, group, Dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    scores = torch.where(live, scores, _NEG_INF)
    ms, ls, accs = [], [], []
    for z in range(n_split):
        a, e = z * per, (S if z == n_split - 1 else min((z + 1) * per, S))
        sz, lz = scores[..., a:e], live[..., a:e]
        m = sz.amax(dim=-1, keepdim=True) if e > a else torch.full_like(scores[..., :1], _NEG_INF)
        p = torch.exp(sz - m) * lz
        ms.append(m[..., 0])
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v[:, a:e].float()))
    m_all = torch.stack(ms)                                   # [n, B, Hkv, G]
    l_all = torch.stack(ls)
    m = m_all.amax(dim=0)
    w = torch.where(l_all > 0, torch.exp(m_all - m), torch.zeros_like(m_all))
    l = (w * l_all).sum(dim=0)
    acc = (w[..., None] * torch.stack(accs)).sum(dim=0)
    out = acc / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return out.reshape(B, H, Dh).to(v.dtype)


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


class _SplitWorkspace:
    """B3a's split-S workspace on one device: f32 partials and the
    per-(batch row, kv head) arrival counters, zeroed once when made.
    The kernel leaves the counters 0, so the buffers are reused by every
    call; they grow when a call needs more and never inside a CUDA graph
    capture (a capture needs them large enough beforehand: one call of
    the same shape outside it)."""

    def __init__(self):
        self.part = self.count = None

    def get(self, device, n_part: int, n_count: int):
        small = (self.part is None or self.part.numel() < n_part
                 or self.count.numel() < n_count)
        if small:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("decode_attention: the split-S workspace is too small "
                                   "for this call inside a CUDA graph capture; call it once "
                                   "at this shape before capturing")
            self.part = torch.empty(max(n_part, 1), dtype=torch.float32, device=device)
            self.count = torch.zeros(max(n_count, 1), dtype=torch.int32, device=device)
        return self.part, self.count


_workspaces = {}


@functools.lru_cache(maxsize=1024)
def _plan(dev: int, B: int, H: int, Hkv: int, S: int, M: int):
    """:func:`decode_split_plan` on device ``dev``, from its SM count and
    the kernel's occupancy at this group and mask height."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occ = ctypes.c_int(0)
    fn = _build.entry("decode_attention", "bcg_decode_attention_occupancy", _OCC_ARGTYPES)
    _build.check(fn(H, Hkv, M, ctypes.byref(occ)), "decode_attention occupancy")
    return decode_split_plan(B, Hkv, S, sms, occ.value)


def _split_for(q, Hkv, S, M):
    """The split plan of a call with q ``[B, H, Dh]`` on a CUDA device."""
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    return _plan(dev, q.shape[0], q.shape[1], Hkv, S, M)


def decode_attention_cuda(q, k, v, mask, scale):
    """Launch ``csrc/decode_attention.cu`` on the current stream: one
    launch, the window split as :func:`decode_split_plan` says."""
    B, H, Dh = q.shape
    m3 = _mask3(mask)
    _check(q, k, v, m3)
    m3 = m3.contiguous()
    fn = _build.entry("decode_attention", "bcg_decode_attention", _ARGTYPES)
    S, Hkv = k.shape[1], k.shape[2]
    M = m3.shape[1]
    n_split, split_len = _split_for(q, Hkv, S, M)
    part_ptr = count_ptr = 0
    if n_split > 1:
        ws = _workspaces.get(q.device)
        if ws is None:
            ws = _workspaces[q.device] = _SplitWorkspace()
        part, count = ws.get(q.device, B * Hkv * n_split * (H // Hkv) * (Dh + 2), B * Hkv)
        part_ptr, count_ptr = part.data_ptr(), count.data_ptr()
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m3.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, M, k.stride(0), k.stride(1), float(scale), n_split, split_len,
             part_ptr, count_ptr, _build.stream_ptr(q))
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, mask, scale):
    """Decode attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask, scale)
    return decode_attention_cuda(q, k, v, mask, scale)


decode_attention.launches = 0


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
    Kq, S]``, one device."""
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
    if k.shape != v.shape or k.stride() != v.stride() or k.stride(3) != 1 \
            or k.shape[3] != dh_store or any(st % align for st in k.stride()[:3]):
        raise ValueError(f"{name} kernel takes k/v {tuple(k.shape)} of one layout with "
                         f"16-byte aligned rows, got strides {k.stride()}/{v.stride()}")
    if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[0] != B \
            or mask.shape[2] != S or mask.shape[1] not in (1, Kq):
        raise ValueError(f"{name} kernel takes a bool mask [B, 1|{Kq}, {S}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if not all(t.device == q.device for t in (k, v, mask)):
        raise ValueError(f"{name}: tensors on different devices")
    for t in (q, k, v):
        if t.data_ptr() % 16:
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
    for t in scales:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, Hkv, S) or t.stride(2) != 1 \
                or t.stride() != scales[0].stride() or t.device != q.device:
            raise ValueError(f"{name} kernel takes f32 scales [B, Hkv, S] with positions "
                             f"contiguous, got {t.dtype} {tuple(t.shape)} {t.stride()}")


def chunk_decode_attention_cuda(q, k, v, mask, scale):
    """Launch ``csrc/chunk_decode_attention.cu`` on the current stream."""
    B, Kq, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    _check_tile(q, k, v, mask, S, Hkv, int8=False)
    mask = mask.contiguous()
    fn = _build.entry("chunk_decode_attention", "bcg_chunk_decode_attention",
                      _CHUNK_ARGTYPES)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, Kq, mask.shape[1], k.stride(0), k.stride(2), k.stride(1),
             float(scale), _build.stream_ptr(q))
    _build.check(err, "chunk_decode_attention")
    chunk_decode_attention.launches += 1
    return out


def _int8_launch(q4, k, v, k_scale, v_scale, m3, scale):
    B, Kq, H, Dh = q4.shape
    Hkv, S = k.shape[1], k.shape[2]
    _check_tile(q4, k, v, m3, S, Hkv, int8=True, scales=(k_scale, v_scale))
    m3 = m3.contiguous()
    fn = _build.entry("decode_attention_int8", "bcg_decode_attention_int8", _INT8_ARGTYPES)
    out = torch.empty_like(q4)
    err = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), k_scale.data_ptr(),
             v_scale.data_ptr(), m3.data_ptr(), out.data_ptr(), B, S, H, Hkv, Kq,
             m3.shape[1], k.stride(0), k.stride(1), k.stride(2), k_scale.stride(0),
             k_scale.stride(1), float(scale), _build.stream_ptr(q4))
    _build.check(err, "decode_attention_int8")
    return out


def decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale):
    """Launch ``csrc/decode_attention_int8.cu`` for one step (rows = the
    GQA group, one mask row shared by all of them)."""
    if mask.dim() != 2:
        raise ValueError(f"decode_attention_int8 takes a [B, S] mask, got {tuple(mask.shape)}")
    out = _int8_launch(q[:, None], k, v, k_scale, v_scale, mask[:, None, :], scale)
    decode_attention_int8.launches += 1
    return out[:, 0]


def chunk_decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale):
    """Launch ``csrc/decode_attention_int8.cu`` for a chunk (rows = K x
    the GQA group, mask ``[B, K, S]``)."""
    out = _int8_launch(q, k, v, k_scale, v_scale, mask, scale)
    chunk_decode_attention_int8.launches += 1
    return out


def chunk_decode_attention(q, k, v, mask, scale):
    """bf16 chunk decode attention: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if q.device.type == "cpu":
        return chunk_decode_attention_plain(q, k, v, mask, scale)
    return chunk_decode_attention_cuda(q, k, v, mask, scale)


def decode_attention_int8(q, k, v, k_scale, v_scale, mask, scale):
    """int8-cache decode step: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale)
    return decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale)


def chunk_decode_attention_int8(q, k, v, k_scale, v_scale, mask, scale):
    """int8-cache chunk decode attention: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return chunk_decode_attention_int8_plain(q, k, v, k_scale, v_scale, mask, scale)
    return chunk_decode_attention_int8_cuda(q, k, v, k_scale, v_scale, mask, scale)


chunk_decode_attention.launches = 0
decode_attention_int8.launches = 0
chunk_decode_attention_int8.launches = 0
