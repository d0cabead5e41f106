"""Prefill attention: the flash kernel's wrapper and its plain version.

Port of ``bcg_tpu/ops/attention.py``.  :func:`flash_attention` computes
``softmax(scale * q @ k^T + mask) @ v`` per head with GQA and an
arbitrary boolean mask, in the model's layouts: q ``[B, T, H, Dh]``,
k/v ``[B, S, Hkv, Dh]`` (the KV-cache layout, read through its strides),
mask ``[B, T, S]`` (True = attend).  On a CUDA tensor it launches the
hand-written kernel ``csrc/flash_prefill.cu``; on a CPU tensor it runs
:func:`flash_attention_plain`.  Nothing falls back silently: a CUDA
input the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from bcg_tpu_torch.ops import _build

_NEG_INF = -1e30
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, mask, out, B, T, S, H, Hkv, kv batch stride, kv seq stride, scale, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, ctypes.c_float, _P]


def flash_attention_plain(q, k, v, mask, scale):
    """The plain PyTorch version: masked softmax attention
    (``transformer._xla_attention``-style, materializing
    ``[B, H, T, S]``) at the kernel's precision and with its rule for
    fully masked rows.  Scores ``q.k`` accumulate in f32 (the Pallas
    kernel's ``preferred_element_type=f32``); ``p = exp(s - max) * mask``
    so a fully masked query row (a left-pad row) gives 0, not a uniform
    average; probabilities are rounded to v's type for the ``p.v``
    product, which accumulates in f32; output in v's type."""
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, Dh).float()
    live = mask[:, None, None, :, :]
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    scores = torch.where(live, scores, _NEG_INF)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * live
    l = p.sum(dim=-1, keepdim=True)
    probs = (p / torch.where(l == 0.0, 1.0, l)).to(v.dtype).float()
    out = torch.einsum("bhgts,bshd->bthgd", probs, v.float())
    return out.reshape(B, T, H, Dh).to(v.dtype)


def _check(q, k, v, mask):
    B, T, H, Dh = q.shape
    if Dh != 128:
        raise ValueError(f"flash_attention kernel takes head_dim 128, got {Dh}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16 q/k/v, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if not q.is_contiguous():
        raise ValueError("flash_attention kernel takes a contiguous q [B, T, H, Dh]")
    S, Hkv = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != Dh or H % Hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if k.stride() != v.stride() or k.stride(3) != 1 or k.stride(2) != Dh \
            or k.stride(1) % 8 or k.stride(0) % 8:
        raise ValueError(f"flash_attention kernel takes k/v with heads-then-dims "
                         f"contiguous and 16-byte aligned rows, got strides {k.stride()}")
    for t in (q, k, v):
        if t.data_ptr() % 16:
            raise ValueError("flash_attention kernel takes 16-byte aligned tensors")
    if mask.dtype != torch.bool or tuple(mask.shape) != (B, T, S) or not mask.is_contiguous():
        raise ValueError(f"flash_attention kernel takes a contiguous bool mask "
                         f"[{B}, {T}, {S}], got {mask.dtype} {tuple(mask.shape)}")
    if not (q.device == k.device == v.device == mask.device):
        raise ValueError("flash_attention: tensors on different devices")


def flash_attention_cuda(q, k, v, mask, scale):
    """Launch ``csrc/flash_prefill.cu`` on the current stream."""
    _check(q, k, v, mask)
    fn = _build.entry("flash_prefill", "bcg_flash_prefill", _ARGTYPES)
    B, T, H, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
             B, T, S, H, Hkv, k.stride(0), k.stride(1), float(scale),
             _build.stream_ptr(q))
    _build.check(err, "flash_prefill")
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, mask, scale):
    """Prefill attention: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.  Returns ``[B, T, H, Dh]``."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, scale)
    return flash_attention_cuda(q, k, v, mask, scale)


flash_attention.launches = 0
