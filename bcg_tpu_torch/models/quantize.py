"""int8 (W8A8) and grouped int4 (W4A16) weight quantization, and the
packed-int4 KV-cache quantizer — the port of ``bcg_tpu/models/quantize.py``.

**Weights.** ``quantization="int8"`` stores every dense matmul weight of a
block (``wq wk wv wo w_gate w_up w_down``) and the LM head as int8 with a
per-output-channel f32 absmax scale; each matmul quantizes its activation
per token (per-row absmax) right before an int8 x int8 -> int32 product
and rescales in f32 (dynamic W8A8).  ``quantization="int4"`` stores them
as grouped absmax int4, two values a byte, with bf16 scales per (group,
output): the matmul dequantizes to bf16 (W4A16) — in registers by the
B5 kernel (:mod:`bcg_tpu_torch.ops.w4_matmul`) for up to 256 rows, and
whole (:func:`dequantize_int4`, then one bf16 product) for the larger
prefill shapes, as the JAX package routes them.  Embeddings and norm
vectors stay bf16; a tied-embedding model gains a quantized ``lm_head``
copy of ``embed.T``.

A quantized leaf is a dict under its logical name in the flat parameter
dict — int8 ``{"q": [in, out], "scale": f32 [out]}``, int4 ``{"q4":
[in/2, out], "gscale": bf16 [in/g, out]}`` — and :func:`dense` dispatches
on it.  The bytes equal the JAX package's: both round half to even.
Where a quantized product goes (W8A16 for large int8 calls, the int4
dequantize route on the CPU) is the model spec's ``dense_route``, which
the engine resolves from the env flags once (:func:`dense_route_from_env`).

Weight packing: the B5 kernel's contract, defined with it in
:mod:`bcg_tpu_torch.ops.w4_matmul` (packed along the CONTRACTION axis, so
the product splits into ``x[:, :in/2]`` against the low nibbles and
``x[:, in/2:]`` against the high ones).  Groups of ``g = gcd(in/2, 128)``
rows.  Both quantized weights are stored output-major (the int8 ``q`` for
cuBLAS's int8 kernel, the packed ``q4`` for B5's loads): the same values
as the JAX package's, in another layout.

**Under a mesh** (the JAX ``_sharded_quantizer``'s global semantics):
each dense weight is quantized WHOLE and then sliced
(:func:`quantize_leaf_transform` with ``mesh``,
``parallel/sharding.shard_leaf``), so every rank's parts are slices of
the one-device quantized tree — a row-parallel int8 scale is the absmax
over all input rows, a row-parallel int4 weight the contiguous slice of
its unpacked rows repacked locally, with the gscale rows of its groups.
A row-parallel product (:func:`dense_row_parallel`) then sums its
partials over ``tp``: W8A8 quantizes the activation with the whole row's
absmax (a max over ``tp``) and sums the int32 partial products exactly,
then scales once, which is one device's product bit for bit; W8A16 and
W4A16 sum f32 partials.

**KV cache.** Packing contract of the int4 KV entries, identical to the
JAX package's: symmetric absmax over the head dim (the last axis), range
[-8, 7], quantized against the bf16-ROUNDED scale (what dequantization
reads); byte ``j`` of a packed row holds element ``j`` in its low nibble
and element ``j + Dh/2`` in its high nibble (packed along the LAST axis:
not the weights' order).  Scales are bf16 — the layout marker
(``transformer.kv_is_int4``) that tells an int4 entry from an int8 one,
whose scales are f32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple, Union

import torch

from bcg_tpu_torch.models.configs import DenseRoute, ModelSpec
# unpack_int4 is the op's packing format, re-exported beside the quantizer.
from bcg_tpu_torch.ops.w4_matmul import (  # noqa: F401
    dequantize_int4, int4_weight_layout, unpack_int4, w4a16_matmul)
from bcg_tpu_torch.runtime import envflags

QuantizedDense = Dict[str, torch.Tensor]
DenseWeight = Union[torch.Tensor, QuantizedDense]

_QUANT_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

INT4_GROUP = 128
# Division by a constant as XLA compiles it, a product with the constant's
# f32 reciprocal: the scales' bits then equal the JAX package's.
_INV127 = 1.0 / 127.0
_INV7 = 1.0 / 7.0
# Rows up to which an int4 matmul runs the B5 kernel; more rows (prefill)
# dequantize the weight once and take one bf16 product.
W4_KERNEL_MAX_ROWS = 256


# ---------------------------------------------------------------- weights

def quantize_weight(w: torch.Tensor) -> QuantizedDense:
    """``[in, out]`` bf16/f32 -> int8 ``q`` + per-output-channel f32 absmax
    ``scale`` (``absmax / 127``, values clipped to [-127, 127])."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=0)
    scale = torch.clamp_min(absmax, 1e-12) * _INV127
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": int8_weight_layout(q), "scale": scale}


def int8_weight_layout(q: torch.Tensor) -> torch.Tensor:
    """An int8 weight ``[in, out]`` as it is stored: the same values, laid
    out output-major (the transpose of a contiguous ``[out, in]``
    tensor).  cuBLAS takes its fast int8 kernel for this operand order;
    row-major ``[in, out]`` sends ``torch._int_mm`` to a much slower one
    on the H100 (``python -m bcg_tpu_torch.tools.int8_layout`` times
    both)."""
    return q.t().contiguous().t()


def int4_group_for(in_dim: int, group: int = INT4_GROUP) -> int:
    """Group size for a weight's contraction dim: ``gcd(in_dim / 2,
    group)``, a divisor of the packed half, so no group straddles the two
    nibble halves (tiny test widths shrink it)."""
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {in_dim}")
    return math.gcd(in_dim // 2, group)


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP) -> QuantizedDense:
    """``[in, out]`` bf16/f32 -> packed int4 ``q4`` ``[in/2, out]`` (stored
    output-major, ``int4_weight_layout``) + bf16 per-(group, output)
    absmax ``gscale`` ``[in/g, out]`` (``absmax / 7``, rounded to bf16
    BEFORE the values are quantized against it, so the half-step error
    bound holds for what dequantization reads)."""
    in_dim, out_dim = w.shape
    g = int4_group_for(in_dim, group)
    grouped = w.float().reshape(in_dim // g, g, out_dim)
    absmax = grouped.abs().amax(dim=1)
    scale = (torch.clamp_min(absmax, 1e-12) * _INV7).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(grouped / scale[:, None, :]), -8, 7)
    q = q.to(torch.int8).reshape(in_dim, out_dim)
    half = in_dim // 2
    packed = (q[:half] & 0x0F) | (q[half:] << 4)
    return {"q4": int4_weight_layout(packed.to(torch.int8)), "gscale": scale.to(torch.bfloat16)}


def is_quantized(w: DenseWeight) -> bool:
    return isinstance(w, dict)


def is_int4(w: DenseWeight) -> bool:
    return isinstance(w, dict) and "q4" in w


def leaf_nbytes(w: DenseWeight) -> int:
    """Bytes of a parameter leaf, a quantized dict's parts summed."""
    parts = w.values() if isinstance(w, dict) else (w,)
    return sum(t.numel() * t.element_size() for t in parts)


def _int8_product(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of ``[M, K]`` and ``[K, N]``
    (``torch._int_mm``; on CUDA it takes more than 16 rows, so a decode
    step's few rows are zero-padded and the pad rows dropped)."""
    M = xq.shape[0]
    if xq.is_cuda and M <= 16:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 17 - M))
        return torch._int_mm(xq, q)[:M]
    return torch._int_mm(xq, q)


def dense_route_from_env() -> DenseRoute:
    """:class:`~bcg_tpu_torch.models.configs.DenseRoute` from
    ``BCG_TPU_W8A16_PREFILL`` and ``BCG_TPU_DISABLE_W4_KERNEL``: read once,
    by the engine at construction, never per product."""
    return DenseRoute(w8a16_rows=envflags.get_int("BCG_TPU_W8A16_PREFILL"),
                      w4_kernel=not envflags.get_bool("BCG_TPU_DISABLE_W4_KERNEL"))


def dense(x: torch.Tensor, w: DenseWeight, out_dtype=None,
          route: DenseRoute = DenseRoute()) -> torch.Tensor:
    """``x @ w`` where ``w`` is a tensor or a quantized dict, cast to
    ``out_dtype`` (default ``x``'s dtype; the logits pass f32).

    * tensor: the product in the promoted type of ``x`` and ``w``.
    * int4: up to :data:`W4_KERNEL_MAX_ROWS` rows through
      :func:`~bcg_tpu_torch.ops.w4_matmul.w4a16_matmul` (f32, the kernel
      on CUDA); more rows, or ``route.w4_kernel=False`` on the CPU,
      dequantize whole and take one bf16 product.  On CUDA
      ``w4_kernel=False`` raises: the card never serves the plain version.
    * int8: per-token absmax activation quantization, an exact int32
      product, ``acc * a_scale * scale`` in f32 — the JAX recipe in its
      operation order.  Calls of at least ``route.w8a16_rows`` rows (0 =
      none) take the dequantized bf16 weight instead (W8A16).
    """
    if out_dtype is None:
        out_dtype = x.dtype
    if not isinstance(w, dict):
        dt = torch.promote_types(x.dtype, w.dtype)
        return (x.to(dt) @ w.to(dt)).to(out_dtype)
    rows = x.numel() // x.shape[-1]
    if "q4" in w:
        if not route.w4_kernel:
            if x.is_cuda:
                raise ValueError(
                    "BCG_TPU_DISABLE_W4_KERNEL: the PyTorch engine runs every "
                    "decode-shaped int4 matmul through the W4A16 kernel on CUDA; "
                    "the dequantize route serves CPU tensors only")
        elif rows <= W4_KERNEL_MAX_ROWS:
            return w4a16_matmul(x, w["q4"], w["gscale"]).to(out_dtype)
        return (x.to(torch.bfloat16) @ dequantize_int4(w)).to(out_dtype)
    if 0 < route.w8a16_rows <= rows:
        w_bf = (w["q"].float() * w["scale"]).to(torch.bfloat16)
        return (x.to(torch.bfloat16) @ w_bf).to(out_dtype)
    x32 = x.float()
    a_scale = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True), 1e-12) * _INV127
    xq = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
    acc = _int8_product(xq.reshape(rows, x.shape[-1]), w["q"])
    acc = acc.reshape(*x.shape[:-1], acc.shape[-1])
    return (acc.float() * a_scale * w["scale"]).to(out_dtype)


def weight_quantizer(mode: str):
    """The one-device weight quantizer of ``mode`` (``"int8"`` or ``"int4"``)."""
    if mode == "int8":
        return quantize_weight
    if mode == "int4":
        return quantize_weight_int4
    raise ValueError(f"quantization mode {mode!r}: expected 'int8' or 'int4'")


def is_quant_leaf(logical: str) -> bool:
    return logical == "lm_head" or (logical.startswith("layers.")
                                    and logical.rsplit(".", 1)[-1] in _QUANT_LEAVES)


def quantize_params(params: Dict, spec: ModelSpec, consume: bool = False,
                    mode: str = "int8") -> Dict:
    """A new flat parameter dict with every block's dense weights and the
    LM head quantized (``mode`` ``"int8"`` or ``"int4"``); a tied-embedding
    model gains a quantized ``lm_head`` from ``embed.T`` while the bf16
    embedding stays for the token gathers.  ``consume=True`` deletes each
    source leaf from ``params`` as it is quantized, so the peak is the
    quantized model plus one full-precision leaf — only for a dict the
    caller owns."""
    quantize = weight_quantizer(mode)
    out = {}
    for name in list(params):
        if is_quant_leaf(name):
            out[name] = quantize(params[name])
            if consume:
                del params[name]
        else:
            out[name] = params[name]
    if "lm_head" not in out and spec.tie_embeddings:
        out["lm_head"] = quantize(out["embed"].T)
    return out


def quantize_leaf_transform(spec: ModelSpec, mode: str = "int8", mesh=None):
    """``transform(logical, tensor)`` for :func:`~bcg_tpu_torch.models.
    convert.init_params`: quantizes each dense weight as it is made, so
    the full-precision model never exists whole.

    With a ``mesh`` whose ``tp`` exceeds 1 the transform takes each FULL
    leaf and returns this rank's slice of it, quantized first where it is
    a dense weight (the sharded quantizer, see the module docstring); its
    ``shards`` attribute tells the loaders to hand it full leaves."""
    from bcg_tpu_torch.parallel.mesh import mesh_shape

    quantize = weight_quantizer(mode)
    if mesh_shape(mesh)["tp"] == 1:
        def transform(logical: str, tensor):
            return quantize(tensor) if is_quant_leaf(logical) else tensor

        transform.shards = False
        return transform
    from bcg_tpu_torch.parallel.sharding import shard_leaf

    def sharded(logical: str, tensor):
        full_shape = tuple(tensor.shape)
        leaf = quantize(tensor) if is_quant_leaf(logical) else tensor
        return shard_leaf(logical, leaf, spec, mesh, full_shape)

    sharded.shards = True
    return sharded


def bf16_product_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` of bf16 operands as its f32 accumulator, before the bf16
    rounding (a row-parallel partial, summed over tp and rounded once)."""
    x2 = x.reshape(-1, x.shape[-1])
    part = (torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda
            else x2.float() @ w.float())
    return part.reshape(*x.shape[:-1], w.shape[-1])


def dense_row_parallel(x: torch.Tensor, w: DenseWeight, mesh,
                       route: DenseRoute = DenseRoute()) -> torch.Tensor:
    """The f32 product of a row-parallel layer: ``x`` and ``w`` are this
    rank's slices of the contraction dim, and the partials are summed over
    ``tp`` (a quantized ``w``; the bf16 form is the transformer's).  W8A8
    takes the activation scale from the whole row (the max over ``tp`` of
    the local absmax) and sums the exact int32 partial products before
    scaling once; W8A16 (``route.w8a16_rows``) sums its bf16 products'
    f32 accumulators and rounds once, as one device rounds its product;
    W4A16 sums f32 partials."""
    from bcg_tpu_torch.parallel.collectives import all_reduce

    rows = x.numel() // x.shape[-1]
    if "q" not in w:
        return all_reduce(dense(x, w, torch.float32, route=route), mesh, "tp")
    if 0 < route.w8a16_rows <= rows:
        # One device rounds its bf16 product once: the partials' f32 sum,
        # rounded once.
        w_bf = (w["q"].float() * w["scale"]).to(torch.bfloat16)
        part = bf16_product_f32(x.to(torch.bfloat16), w_bf)
        return all_reduce(part, mesh, "tp").to(torch.bfloat16).float()
    x32 = x.float()
    absmax = all_reduce(x32.abs().amax(dim=-1, keepdim=True), mesh, "tp", op="max")
    a_scale = torch.clamp_min(absmax, 1e-12) * _INV127
    xq = torch.clamp(torch.round(x32 / a_scale), -127, 127).to(torch.int8)
    acc = _int8_product(xq.reshape(rows, x.shape[-1]), w["q"])
    acc = all_reduce(acc, mesh, "tp")
    acc = acc.reshape(*x.shape[:-1], acc.shape[-1])
    return acc.float() * a_scale * w["scale"]


def ensure_quantized_head(params: Dict, spec: ModelSpec, mode: str = "int8") -> Dict:
    """Give a tied-embedding model its quantized ``lm_head`` (in place)
    when a leaf transform built the rest of the tree.  Under a mesh the
    rank's ``embed`` rows are its vocabulary slice, so ``embed.T`` is its
    slice of the head's columns, whose quantization (per output column,
    over the whole hidden dim) is the one-device head's slice."""
    if "lm_head" not in params and spec.tie_embeddings:
        params["lm_head"] = weight_quantizer(mode)(params["embed"].T)
    return params


# ----------------------------------------------------------------- KV cache


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
