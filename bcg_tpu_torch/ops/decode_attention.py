"""Decode-step attention (T = 1) over the bf16 KV cache: the kernel's
wrapper and its plain version.

Port of ``bcg_tpu/ops/decode_attention.py`` (bf16 single-step form).
Layouts: q ``[B, H, Dh]``; k/v ``[B, S, Hkv, Dh]`` (the cache layout,
S-major); mask ``[B, S]`` (attendable slots, shared by every query row)
or ``[B, M, S]`` with ``M`` = 1 or the GQA group (one row per query head
of a kv head — the form a chunk wrapper will use).  Returns
``[B, H, Dh]``.  On a CUDA tensor :func:`decode_attention` launches
``csrc/decode_attention.cu``; on a CPU tensor it runs
:func:`decode_attention_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from bcg_tpu_torch.ops import _build
from bcg_tpu_torch.ops.attention import flash_attention_plain

MAX_GROUP = 8   # query rows per kv head the kernel holds (csrc kMaxG)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, mask, out, B, S, H, Hkv, M, kv batch stride, kv seq stride, scale, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, ctypes.c_float, _P]


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
    if group > MAX_GROUP:
        raise ValueError(f"decode_attention kernel takes GQA groups up to {MAX_GROUP}, got {group}")
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


def decode_attention_cuda(q, k, v, mask, scale):
    """Launch ``csrc/decode_attention.cu`` on the current stream."""
    B, H, Dh = q.shape
    m3 = _mask3(mask)
    _check(q, k, v, m3)
    m3 = m3.contiguous()
    fn = _build.entry("decode_attention", "bcg_decode_attention", _ARGTYPES)
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), m3.data_ptr(), out.data_ptr(),
             B, S, H, Hkv, m3.shape[1], k.stride(0), k.stride(1), float(scale),
             _build.stream_ptr(q))
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
