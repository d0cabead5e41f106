"""The packed-int4 KV-cache quantizer — the KV half of
``bcg_tpu/models/quantize.py`` (``kv_int4_layout``, ``quantize_kv_int4``,
``unpack_kv_int4``, ``dequantize_kv_int4``).  The weight half (W8A8
``dense``, the int4 weight packing and its kernel) is ROADMAP A8/B5.

Packing contract, identical to the JAX package's so the bytes match:
symmetric absmax over the head dim (the last axis), range [-8, 7],
quantized against the bf16-ROUNDED scale (what dequantization reads);
byte ``j`` of a packed row holds element ``j`` in its low nibble and
element ``j + Dh/2`` in its high nibble.  Scales are bf16 — the layout
marker (``transformer.kv_is_int4``) that tells an int4 entry from an
int8 one, whose scales are f32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def kv_int4_layout(head_dim: int) -> Tuple[int, torch.dtype]:
    """(storage head dim, scale dtype) of the packed-int4 KV layout: the
    one definition the dense slab, the paged pool and the engine's boot
    check derive from."""
    if head_dim % 2:
        raise ValueError(f"int4 KV packing needs an even head dim, got {head_dim}")
    return head_dim // 2, torch.bfloat16


def quantize_kv_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16/f32 ``[..., Dh]`` -> (packed int8 ``[..., Dh/2]``, bf16
    per-row absmax scale ``[...]``)."""
    half, scale_dtype = kv_int4_layout(x.shape[-1])
    x32 = x.float()
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax == 0.0, torch.ones_like(absmax), absmax / 7.0)
    scale = scale.to(scale_dtype).float()
    q = torch.clamp(torch.round(x32 / scale), -8, 7).to(torch.int8)
    packed = (q[..., :half] & 0x0F) | (q[..., half:] << 4)
    return packed.to(torch.int8), scale.squeeze(-1).to(scale_dtype)


def unpack_kv_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[..., Dh/2]`` int8 -> ``[..., Dh]`` int8 in [-8, 7]: low
    nibbles first, each sign-extended by an arithmetic shift (in int32,
    where the shifts cannot overflow)."""
    p = packed.to(torch.int32)
    low = (p << 28) >> 28
    high = p >> 4
    return torch.cat([low, high], dim=-1).to(torch.int8)


def dequantize_kv_int4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 KV from a packed slice and its bf16 scales (the plain paths'
    oracle; the paged kernel unpacks in registers)."""
    return unpack_kv_int4(packed).float() * scale.float().unsqueeze(-1)
