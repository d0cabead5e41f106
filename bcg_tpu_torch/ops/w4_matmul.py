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
32 and ``F`` a multiple of 16, with ``q4`` stored output-major
(:func:`int4_weight_layout`: the same logical tensor, laid out as the
transpose of a contiguous ``[F, D/2]``, so that a column's packed rows
are contiguous); ``models/quantize`` and ``models/convert`` emit that
layout.  :func:`split_plan` sizes the launch; where it splits the
contraction across blocks, the kernel's partials and arrival counters
live in a workspace the wrapper owns (:func:`workspace`), grown outside
CUDA graph capture only.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple

import torch

from bcg_tpu_torch.ops import _build
from bcg_tpu_torch.ops.decode_attention import SplitWorkspace

MAX_ROWS = 256       # rows the kernel takes (the dense dispatch's decode shapes)
# csrc/w4a16.cu: threads (warps) a block, packed rows of a warp step,
# the ring (four stages of each thread's 2 x 16 weight bytes and four
# scale words), a warp's staged accumulators per n-tile.
_THREADS, _WARPS, _CHUNK = 512, 16, 64
_RING_BYTES = 4 * _THREADS * (2 * 16 + 4 * 4)
_RED_BYTES = 8 * 20 * 4
SMEM_BUDGET = 225 * 1024   # dynamic shared memory a launch may take (the card's 227 KB opt-in)
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
# x, q4, gscale, out, part, count, M, P, F, ng, gmagic, gshift, nt, wc,
# splits, kb, gx, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _U, _I, _I, _I, _I, _I, _I, _P]


def int4_weight_layout(q4: torch.Tensor) -> torch.Tensor:
    """A packed int4 weight ``[D/2, F]`` as the kernel takes it: the same
    values, laid out output-major (the transpose of a contiguous ``[F,
    D/2]``), so that the 16 bytes a thread copies are 16 packed rows of one
    output column."""
    return q4.t().contiguous().t()


def is_kernel_layout(q4: torch.Tensor) -> bool:
    return q4.dim() == 2 and q4.stride() == (1, q4.shape[0])


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


class W4Plan(NamedTuple):
    """A launch of ``csrc/w4a16.cu``: ``nt`` n-tiles of 8 rows a row block
    (``mblocks`` row blocks), ``wc`` column warps (tiles of ``16 * wc``
    output columns; the other ``16 / wc`` warps of a column share its
    packed rows), the contraction cut into ``splits`` ranges of ``kb``
    packed rows, ``gx`` blocks along the columns (each walking every
    ``gx``-th tile)."""
    nt: int
    wc: int
    splits: int
    kb: int
    gx: int
    mblocks: int


def smem_bytes(nt: int, wc: int, rows: int, kb: int) -> int:
    """Dynamic shared memory of a launch: the ring, the accumulators the
    warps past each column's first stage, and x's ``rows`` rows over
    ``kb`` packed rows of each half (csrc/w4a16.cu)."""
    return _RING_BYTES + (_WARPS - wc) * nt * _RED_BYTES + rows * (2 * kb + 4) * 2


# The planner's cost model, µs, fitted to graph-timed sweeps of every plan
# at bench-8b's shapes (``tools/w4_kernels.py --sweep``; one block an
# SM): the weight bytes at the card's rate, or the busiest block's at the
# rate one SM streams them, whichever is longer; every block's x from L2;
# a block barrier a tile (longer with more k-groups to add); and for a
# split, each tile's merge (the counter's round trip, and the last
# block's read of every split's partial).
_HBM_BYTES_PER_US = 3.35e6
_SM_BYTES_PER_US = 16e3
_L2_BYTES_PER_US = 5e6
_MERGE_BYTES_PER_US = 50e3
_FLUSH_US, _FLUSH_US_PER_KGROUP = 1.0, 0.1
_MERGE_US = 1.5


def split_plan(M: int, P: int, F: int, sms: int) -> W4Plan:
    """The launch for x ``[M, 2P]`` times a ``[P, F]`` packed weight on
    ``sms`` SMs: rows in n-tiles of 8 (up to 64 a row block), then the
    column warps and contraction splits of least modelled time (the cost
    model above), among those whose x fits shared memory.  One block an
    SM: more tiles than SMs are walked by each block in turn, fewer are
    split along the contraction where that pays for its merge."""
    nt = 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8
    mblocks = -(-M // (8 * nt))
    rows = min(M, 8 * nt)
    nchunk = -(-P // _CHUNK)
    best = None
    for wc in (16, 8, 4, 2, 1):
        bn = 16 * wc
        tiles = -(-F // bn)
        seen = set()
        for want in range(1, nchunk + 1):
            cps = -(-nchunk // want)                 # chunks a split
            splits = -(-nchunk // cps)
            kb = cps * _CHUNK
            if splits in seen or smem_bytes(nt, wc, rows, kb) > SMEM_BUDGET:
                continue
            seen.add(splits)
            per_row = splits * mblocks
            gx = tiles if tiles * per_row <= sms else max(1, sms // per_row)
            rounds = -(-tiles // gx)                  # tiles the busiest block walks
            cost = (max(P * F * mblocks / _HBM_BYTES_PER_US, rounds * bn * kb / _SM_BYTES_PER_US)
                    + gx * per_row * rows * 4 * kb / _L2_BYTES_PER_US
                    + rounds * (_FLUSH_US + _FLUSH_US_PER_KGROUP * (_WARPS // wc)
                                + (splits > 1) * (_MERGE_US + splits * rows * bn * 4
                                                  / _MERGE_BYTES_PER_US)))
            if best is None or cost < best[0]:
                best = (cost, W4Plan(nt, wc, splits, kb, gx, mblocks))
    if best is None:
        raise ValueError(f"w4a16: no launch fits shared memory for {M} rows over P = {P}")
    return best[1]


def group_magic(group: int):
    """``(gmagic, gshift)`` with ``(umulhi(r, gmagic) + r) >> gshift ==
    r // group`` for every packed row ``r < 2**31`` (round-up
    multiply-shift division, Granlund and Montgomery): the kernel's group
    of a row without a divide."""
    shift = max(0, math.ceil(math.log2(group)))
    magic = (2 ** 32 * (2 ** shift - group)) // group + 1
    return magic, shift


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
    if P % ng or (P // ng) % 32:
        raise ValueError(f"w4a16 kernel takes groups that are multiples of 32 rows, "
                         f"got {P}/{ng}")
    if F % 16:
        raise ValueError(f"w4a16 kernel takes an output width that is a multiple of 16, got {F}")
    if not is_kernel_layout(q4):
        raise ValueError(f"w4a16 kernel takes q4 output-major (int4_weight_layout: strides "
                         f"(1, {P})), got strides {q4.stride()}")
    for t in (x, q4, gscale):
        if t.data_ptr() % 16:
            raise ValueError("w4a16 kernel takes 16-byte aligned tensors")
    if not (x.is_contiguous() and gscale.is_contiguous()):
        raise ValueError("w4a16 kernel takes contiguous x and gscale")
    if not (x.device == q4.device == gscale.device):
        raise ValueError("w4a16: tensors on different devices")


_workspaces: Dict[torch.device, SplitWorkspace] = {}


def workspace(device, plan: W4Plan, M: int, F: int):
    """Pointers to the partials and counters of a launch (0, 0 for one
    split): ``splits * M * F`` floats and a counter per (row block,
    tile)."""
    if plan.splits == 1:
        return 0, 0
    ws = _workspaces.get(device)
    if ws is None:
        ws = _workspaces[device] = SplitWorkspace("w4a16")
    part, count = ws.get(device, plan.splits * M * F, plan.mblocks * -(-F // (16 * plan.wc)))
    return part.data_ptr(), count.data_ptr()


@functools.lru_cache(maxsize=1024)
def _plan_for(M: int, P: int, F: int, dev: int) -> W4Plan:
    return split_plan(M, P, F, torch.cuda.get_device_properties(dev).multi_processor_count)


def w4a16_matmul_cuda(x, q4, gscale, plan: W4Plan = None):
    """Launch ``csrc/w4a16.cu`` on the current stream (``x`` ``[M, D]``):
    one launch, at :func:`split_plan`'s plan unless ``plan`` is given."""
    x = x.to(torch.bfloat16).contiguous()
    _check(x, q4, gscale)
    M, P, F = x.shape[0], q4.shape[0], q4.shape[1]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if plan is None:
        plan = _plan_for(M, P, F, dev)
    ng = gscale.shape[0] // 2
    gmagic, gshift = group_magic(P // ng)
    part_ptr, count_ptr = workspace(x.device, plan, M, F)
    out = torch.empty((M, F), dtype=torch.float32, device=x.device)
    fn = _build.entry("w4a16", "bcg_w4a16", _ARGTYPES)
    err = fn(x.data_ptr(), q4.data_ptr(), gscale.data_ptr(), out.data_ptr(), part_ptr,
             count_ptr, M, P, F, ng, gmagic, gshift, plan.nt, plan.wc, plan.splits, plan.kb,
             plan.gx, _build.stream_ptr(x))
    _build.check(err, "w4a16")
    w4a16_matmul.launches += 1
    return out


def w4a16_matmul(x, q4, gscale):
    """``x @ dequant(q4, gscale)`` as f32 ``[..., F]``: the kernel on CUDA,
    the plain version on the CPU."""
    lead = x.shape[:-1]
    x2 = x.reshape(math.prod(lead), x.shape[-1])
    w4a16_matmul.calls += 1
    if x.device.type == "cpu":
        out = w4a16_matmul_plain(x2, q4, gscale)
    else:
        out = w4a16_matmul_cuda(x2, q4, gscale)
    return out.reshape(*lead, q4.shape[1])


w4a16_matmul.launches = 0
w4a16_matmul.calls = 0
