"""W4A16 matrix product over grouped-int4 weights: the B5 kernel's
wrapper and its plain version.

Port of ``bcg_tpu/ops/w4_matmul.py``.  :func:`w4a16_matmul` computes ``x
@ dequant(q4, gscale)`` in f32 for ``x`` ``[..., D]`` (any leading dims),
the packed weight ``q4`` int8 ``[D/2, F]`` and its bf16 group scales
``gscale`` ``[D/g, F]``.  This module owns that packing format, which
``models/quantize.quantize_weight_int4`` writes: byte ``[i, f]`` holds
row ``i`` in its low nibble and row ``D/2 + i`` in its high nibble, and
``gscale`` holds the top half's groups first (:func:`unpack_int4`,
:func:`dequantize_int4`).  A CPU tensor runs
:func:`w4a16_matmul_plain`; a CUDA tensor launches ``csrc/w4a16.cu``
(:func:`w4a16_matmul_cuda`) or raises.  ``w4a16_matmul.launches`` counts
the kernel's launches.

The kernel takes 1 to :data:`MAX_ROWS` rows, groups that are multiples of
32 and ``F`` a multiple of 16; where the output has too few 128-column
blocks to fill the card it splits the contraction across blocks
(:func:`split_plan`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from bcg_tpu_torch.ops import _build

MAX_ROWS = 256       # rows the kernel takes (the dense dispatch's decode shapes)
_BN, _KT = 128, 32   # csrc/w4a16.cu: output columns per block, packed rows per stage
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, q4, gscale, out, ws, M, P, F, group, splits, kt_per_split, mt, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
_SMS: Dict[int, int] = {}


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``[D/2, F]`` int8 -> ``[D, F]`` int8 in [-8, 7]: the low
    nibbles (the top half's rows) first, each sign-extended by an
    arithmetic shift in int32."""
    p = packed.to(torch.int32)
    return torch.cat([(p << 28) >> 28, p >> 4], dim=0).to(torch.int8)


def dequantize_int4(w: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The bf16 weight ``[D, F]`` of an int4 dict ``{"q4", "gscale"}``:
    each value times its group's scale in f32, rounded to bf16 (what the
    kernel computes in registers)."""
    q = unpack_int4(w["q4"]).float()
    gscale = w["gscale"].float()
    group = q.shape[0] // gscale.shape[0]
    scaled = q.reshape(gscale.shape[0], group, -1) * gscale[:, None, :]
    return scaled.reshape(q.shape).to(torch.bfloat16)


def w4a16_matmul_plain(x, q4, gscale):
    """The plain PyTorch version, the TPU kernel's function: the weight
    dequantized to bf16 (:func:`dequantize_int4`), then an f32 product of
    bf16-rounded ``x`` with it.  ``x`` ``[M, D]``; returns f32 ``[M, F]``."""
    w = dequantize_int4({"q4": q4, "gscale": gscale})
    return x.to(torch.bfloat16).float() @ w.float()


def split_plan(M: int, P: int, F: int, sms: int) -> Tuple[int, int, int]:
    """``(mt, splits, kt_per_split)`` of a launch: m-tiles of 16 rows per
    block (1, 2 or 4), and the contraction split into ``splits`` ranges of
    ``kt_per_split`` 32-row stages each, so that the grid holds about two
    blocks per SM where the output alone gives fewer (a split keeps at
    least 4 stages)."""
    mt = 1 if M <= 16 else 2 if M <= 32 else 4
    base = -(-F // _BN) * -(-M // (16 * mt))
    nkt = P // _KT
    splits = max(1, min(-(-2 * sms // base), nkt // 4))
    kt_per_split = -(-nkt // splits)
    return mt, -(-nkt // kt_per_split), kt_per_split


def _check(x, q4, gscale):
    M, D = x.shape
    P, F = q4.shape
    if x.dtype != torch.bfloat16 or q4.dtype != torch.int8 or gscale.dtype != torch.bfloat16:
        raise TypeError(f"w4a16 kernel takes bf16 x, int8 q4 and bf16 gscale, got "
                        f"{x.dtype}/{q4.dtype}/{gscale.dtype}")
    if D != 2 * P or gscale.dim() != 2 or gscale.shape[1] != F or gscale.shape[0] % 2:
        raise ValueError(f"w4a16: x {tuple(x.shape)}, q4 {tuple(q4.shape)} and gscale "
                         f"{tuple(gscale.shape)} do not match")
    ng = gscale.shape[0] // 2
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"w4a16 kernel takes 1 to {MAX_ROWS} rows, got {M}")
    if P % ng or (P // ng) % _KT:
        raise ValueError(f"w4a16 kernel takes groups that are multiples of {_KT} rows, "
                         f"got {P}/{ng}")
    if F % 16:
        raise ValueError(f"w4a16 kernel takes an output width that is a multiple of 16, got {F}")
    for t in (x, q4, gscale):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("w4a16 kernel takes contiguous, 16-byte aligned tensors")
    if not (x.device == q4.device == gscale.device):
        raise ValueError("w4a16: tensors on different devices")


def w4a16_matmul_cuda(x, q4, gscale):
    """Launch ``csrc/w4a16.cu`` on the current stream (``x`` ``[M, D]``)."""
    x = x.to(torch.bfloat16).contiguous()
    _check(x, q4, gscale)
    M, P, F = x.shape[0], q4.shape[0], q4.shape[1]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    sms = _SMS.get(dev)
    if sms is None:
        sms = _SMS[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    mt, splits, kt_per_split = split_plan(M, P, F, sms)
    out = torch.empty((M, F), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, M, F), dtype=torch.float32, device=x.device)
          if splits > 1 else out)
    fn = _build.entry("w4a16", "bcg_w4a16", _ARGTYPES)
    err = fn(x.data_ptr(), q4.data_ptr(), gscale.data_ptr(), out.data_ptr(), ws.data_ptr(),
             M, P, F, P // (gscale.shape[0] // 2), splits, kt_per_split, mt,
             _build.stream_ptr(x))
    _build.check(err, "w4a16")
    w4a16_matmul.launches += 1
    return out


def w4a16_matmul(x, q4, gscale):
    """``x @ dequant(q4, gscale)`` as f32 ``[..., F]``: the kernel on CUDA,
    the plain version on the CPU."""
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), x.shape[-1])
    if x.device.type == "cpu":
        out = w4a16_matmul_plain(x2, q4, gscale)
    else:
        out = w4a16_matmul_cuda(x2, q4, gscale)
    return out.reshape(*lead, q4.shape[1])


w4a16_matmul.launches = 0
