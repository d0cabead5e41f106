"""Functional decoder-only transformer (RMSNorm / RoPE / GQA / SwiGLU) in
PyTorch — the port of ``bcg_tpu/models/transformer.py``.

* Parameters are a flat dict of tensors keyed by :func:`param_plan`'s
  logical names (``"embed"``, ``"layers.3.wq"``, ...); dense weights are
  ``[in, out]`` as in the JAX package, so ``x @ w`` reads the same.  A
  quantized weight is a dict under the same name, and every matmul goes
  through :func:`bcg_tpu_torch.models.quantize.dense`, which dispatches on
  it (int8 W8A8, int4 W4A16 through the B5 kernel).
* Prefill is ``[B, L]`` with an explicit validity mask (left-padded
  batches); decode is a ``[B, 1]`` step against a preallocated KV cache.
* Weights and KV cache are bf16 on the served path; RMSNorm accumulates in
  f32; attention softmax runs in f32.  Where the JAX package promotes
  mixed dtypes implicitly (an f32 query against a bf16 cache), this
  module promotes explicitly to the same result type, so f32 weights on
  the CPU reproduce the JAX numbers.
* The dense KV cache is bf16 ``[B, S, Hkv, Dh]``, int8 ``[B, Hkv, S,
  Dh]`` with f32 per-(position, kv head) scales ``[B, Hkv, S]``
  (``init_kv_cache(quantized="int8")``), or packed int4 ``[B, Hkv, S,
  Dh/2]`` with bf16 scales (``quantized="int4"``); the scale entries mark
  a quantized entry and their dtype tells int4 from int8.
* A PAGED entry (a block pool plus a ``"tbl"`` block table,
  :mod:`bcg_tpu_torch.ops.paged_attention`) takes the same calls: its
  writes go through the table, its decode attention through the paged
  kernel, and a prefill's history is gathered from whole table columns
  (:func:`prefill_paged`, :func:`prefill_paged_chunk_at`).
* Attention goes through the hand-written kernels' wrappers
  (:mod:`bcg_tpu_torch.ops.attention` for prefill,
  :mod:`bcg_tpu_torch.ops.decode_attention` for the decode step and the
  decode chunks of the fast-forward and speculative loops,
  :mod:`bcg_tpu_torch.ops.paged_attention` for a paged cache), which launch
  the CUDA kernel on a CUDA tensor and run the plain version on a CPU
  tensor.
* Where JAX returns a NEW cache, this module writes the cache IN PLACE
  and returns the same entries (see :func:`_write_cache`).  A write slot
  may be a device tensor, so the decode loops never read it back.
* Under a mesh (``spec.par``, a :class:`~bcg_tpu_torch.parallel.sharding.
  ModelParallel`) each rank holds its slices of the weights and computes
  with its local head counts: column-parallel q/k/v and gate/up products,
  row-parallel ``wo`` and ``w_down`` each followed by one f32 sum over
  ``tp``, a vocabulary-split embedding (a masked local lookup, then a sum)
  and LM head (local logits, then a gather along the vocabulary) — what
  GSPMD inserts in the JAX package.  A cache split over ``sp``
  (``KVCache.seq0``) holds one slice of the sequence: a rank writes only
  the slots it owns, and attention over it merges the slices
  (:mod:`bcg_tpu_torch.ops.ring_attention`); :func:`prefill_sp` sends the
  prompt's k/v blocks round the ring.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bcg_tpu_torch.models.configs import ModelSpec
from bcg_tpu_torch.models.quantize import dense
from bcg_tpu_torch.ops.attention import flash_attention
from bcg_tpu_torch.ops.decode_attention import (
    chunk_decode_attention,
    chunk_decode_attention_int8,
    decode_attention,
    decode_attention_int8,
    dequantize_kv,
    quantize_kv,
)
from bcg_tpu_torch.parallel.collectives import all_gather, all_reduce, broadcast
from bcg_tpu_torch.ops.paged_attention import (
    block_size as paged_block_size,
    is_paged,
    paged_chunk_attention,
    paged_decode_attention,
    paged_gather_entry,
    paged_write,
    write_index as paged_write_index,
)

TransformerParams = Dict  # flat: logical name -> tensor, or a quantized dict


class KVCache(list):
    """Per-layer dense cache entries, all views of ONE buffer ``buf`` —
    one memset to allocate, one copy to move a prefix entry into a batch
    cache.  bf16: ``{"k", "v"}`` ``[B, S, Hkv, Dh]`` of ``buf``
    ``[num_layers, 2, B, S, Hkv, Dh]``.  int8 / int4: ``{"k", "v"}``
    ``[B, Hkv, S, Dh]`` (int4: ``Dh/2``, packed) of ``buf``
    ``[num_layers, 2, B, Hkv, S, *]`` and ``{"k_scale", "v_scale"}``
    ``[B, Hkv, S]`` (f32; int4: bf16) of ``scales``
    ``[num_layers, 2, B, Hkv, S]``."""

    def __init__(self, buf: torch.Tensor, scales: Optional[torch.Tensor] = None,
                 seq0: Optional[int] = None, seq_total: Optional[int] = None):
        super().__init__(
            {"k": buf[li, 0], "v": buf[li, 1]} if scales is None else
            {"k": buf[li, 0], "v": buf[li, 1], "k_scale": scales[li, 0],
             "v_scale": scales[li, 1]}
            for li in range(buf.shape[0])
        )
        self.buf = buf
        self.scales = scales
        # An sp-split cache holds slots [seq0, seq0 + S_local) of a
        # sequence of ``seq_total`` slots; None: the whole sequence.
        self.seq0 = seq0
        self.seq_total = seq_total if seq_total is not None else buf.shape[self.seq_dim]

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    @property
    def seq_dim(self) -> int:
        """The S axis of ``buf`` (and, int8, of ``scales``)."""
        return 4 if self.quantized else 3

    def nbytes(self) -> int:
        n = self.buf.numel() * self.buf.element_size()
        if self.scales is not None:
            n += self.scales.numel() * self.scales.element_size()
        return n


_NEG_INF = -1e30


# ----------------------------------------------------------------- building

def param_plan(spec: ModelSpec):
    """Ordered ``(logical_name, init_kind, shape)`` triples for every
    leaf — the same plan, names and shapes as the JAX package's
    ``param_plan`` (``"dense"`` = random / sqrt(fan_in), ``"ones"`` =
    norm vectors, ``"zeros"`` = projection biases)."""
    plan = [
        ("embed", "dense", (spec.vocab_size, spec.hidden_size)),
        ("final_norm", "ones", (spec.hidden_size,)),
    ]
    for li in range(spec.num_layers):
        pre = f"layers.{li}."
        plan += [
            (pre + "attn_norm", "ones", (spec.hidden_size,)),
            (pre + "wq", "dense", (spec.hidden_size, spec.q_size)),
            (pre + "wk", "dense", (spec.hidden_size, spec.kv_size)),
            (pre + "wv", "dense", (spec.hidden_size, spec.kv_size)),
            (pre + "wo", "dense", (spec.q_size, spec.hidden_size)),
            (pre + "mlp_norm", "ones", (spec.hidden_size,)),
            (pre + "w_gate", "dense", (spec.hidden_size, spec.intermediate_size)),
            (pre + "w_up", "dense", (spec.hidden_size, spec.intermediate_size)),
            (pre + "w_down", "dense", (spec.intermediate_size, spec.hidden_size)),
        ]
        if spec.qk_norm:
            plan += [
                (pre + "q_norm", "ones", (spec.head_dim,)),
                (pre + "k_norm", "ones", (spec.head_dim,)),
            ]
        if spec.attn_bias:
            plan += [
                (pre + "bq", "zeros", (spec.q_size,)),
                (pre + "bk", "zeros", (spec.kv_size,)),
                (pre + "bv", "zeros", (spec.kv_size,)),
            ]
    if not spec.tie_embeddings:
        plan.append(("lm_head", "dense", (spec.hidden_size, spec.vocab_size)))
    return plan


_LAYER_LEAVES = (
    "attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up",
    "w_down", "q_norm", "k_norm", "bq", "bk", "bv",
)


def _layer(params: TransformerParams, li: int) -> Dict[str, torch.Tensor]:
    pre = f"layers.{li}."
    return {n: params[pre + n] for n in _LAYER_LEAVES if pre + n in params}


# ------------------------------------------------------------------ kernels

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale).to(x.dtype) * weight


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               scaling=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for the given positions ([..., P] -> [..., P, Dh/2]),
    with the Llama-3.1 "llama3" NTK-by-parts branch when ``scaling`` is
    a :class:`~bcg_tpu_torch.models.configs.RopeScaling`."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=dev) / head_dim
    ))
    if scaling is not None:
        wavelen = 2.0 * math.pi / inv_freq
        low_wl = scaling.original_max_position / scaling.low_freq_factor
        high_wl = scaling.original_max_position / scaling.high_freq_factor
        smooth = (
            scaling.original_max_position / wavelen - scaling.low_freq_factor
        ) / (scaling.high_freq_factor - scaling.low_freq_factor)
        inv_freq = torch.where(
            wavelen > low_wl,
            inv_freq / scaling.factor,
            torch.where(
                wavelen < high_wl,
                inv_freq,
                (1 - smooth) * inv_freq / scaling.factor + smooth * inv_freq,
            ),
        )
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate half (HF convention). x: [B, T, H, Dh]; cos/sin: [B, T, Dh/2]."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _promote(*ts: torch.Tensor):
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def _xla_attention(q, k, v, mask, scale):
    """Plain attention: einsum -> masked f32 softmax -> einsum, with the
    JAX package's dtype semantics (scores in the promoted q/k type, then
    f32; probabilities cast to v's type; output in v's type).

    q: [B, T, H, Dh], k/v: [B, S, Hkv, Dh], mask: [B, T, S] bool.
    """
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    qg, kk = _promote(q.reshape(B, T, Hkv, group, Dh), k)
    logits = torch.einsum("bthgd,bshd->bhgts", qg, kk).float() * scale
    logits = torch.where(mask[:, None, None, :, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(B, T, H, Dh)


def attention(q, k, v, mask, scale):
    """Prefill attention through the flash kernel's wrapper (its plain
    version on CPU tensors).  The JAX package's ``impl`` choice is gone:
    the port always runs its kernel, and :func:`_xla_attention` is the
    tests' reference."""
    return flash_attention(q, k, v, mask, scale)


# ------------------------------------------------------------------ forward

def init_kv_cache(spec: ModelSpec, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu", quantized=False,
                  seq_split: bool = False) -> KVCache:
    """Zero-filled dense cache (see :class:`KVCache`): bf16 ``{"k", "v"}``
    ``[B, S, Hkv, Dh]``, or with ``quantized`` (True or ``"int8"``) int8
    ``[B, Hkv, S, Dh]`` — one kv head's positions adjacent, so a kernel
    streams them with 16-byte loads — plus f32 scales ``[B, Hkv, S]``
    initialised to ones; ``"int4"``: the packed ``[B, Hkv, S, Dh/2]`` int8
    slab with bf16 scales.  Under a mesh ``Hkv`` is the rank's kv heads,
    and with ``seq_split`` (and ``sp`` > 1) the cache is this rank's
    ``S / sp`` slots of the sequence."""
    L, Hkv, Dh = spec.num_layers, spec.num_kv_heads, spec.head_dim
    par = spec.par
    seq0 = total = None
    if par is not None:
        Hkv = par.kv_heads
        if seq_split and par.sp > 1:
            if max_len % par.sp:
                raise ValueError(f"cache length {max_len} not divisible by sp={par.sp}")
            total, max_len = max_len, max_len // par.sp
            seq0 = par.sp_rank * max_len
    if quantized:
        dh_store, scale_dtype = Dh, torch.float32
        if quantized == "int4":
            from bcg_tpu_torch.models.quantize import kv_int4_layout

            dh_store, scale_dtype = kv_int4_layout(Dh)
        return KVCache(
            torch.zeros((L, 2, batch, Hkv, max_len, dh_store), dtype=torch.int8, device=device),
            torch.ones((L, 2, batch, Hkv, max_len), dtype=scale_dtype, device=device),
            seq0=seq0, seq_total=total,
        )
    shape = (batch, max_len, Hkv, Dh)
    return KVCache(torch.zeros((L, 2) + shape, dtype=dtype, device=device), seq0=seq0,
                   seq_total=total)


def kv_is_int4(entry: Dict) -> bool:
    """True for a packed-int4 KV entry: its scales are bf16 where the int8
    arm's are f32 (the JAX package's layout marker)."""
    return "k_scale" in entry and entry["k_scale"].dtype == torch.bfloat16


def _kv_quantizer(entry: Dict):
    """The fresh-KV quantizer a quantized entry needs, chosen by its
    scale dtype: ``[B, T, Hkv, Dh] -> (int8 [B, T, Hkv, Dh] and f32
    scales, or packed int4 [B, T, Hkv, Dh/2] and bf16 scales)``."""
    if kv_is_int4(entry):
        from bcg_tpu_torch.models.quantize import quantize_kv_int4

        return quantize_kv_int4
    return quantize_kv


def _kv_dequantizer(entry: Dict):
    """The matching ``(values, scale) -> f32`` dequantizer."""
    if kv_is_int4(entry):
        from bcg_tpu_torch.models.quantize import dequantize_kv_int4

        return dequantize_kv_int4
    return dequantize_kv


def _dequant_view(entry: Dict, dtype):
    """A quantized dense entry's whole k/v window as a contiguous ``[B, S,
    Hkv, Dh]`` tensor in ``dtype`` (dequantized in f32, then rounded): the
    bf16 decode kernel takes a head stride of ``Dh`` only."""
    deq = _kv_dequantizer(entry)
    return tuple(deq(entry[n], entry[f"{n}_scale"]).transpose(1, 2)
                 .to(dtype, memory_format=torch.contiguous_format) for n in ("k", "v"))


def _write_cache(entry: Dict, k, v, pos, seq0: Optional[int] = None) -> Dict:
    """Write fresh k/v ``[B, T, Hkv, Dh]`` into the cache entry IN PLACE at
    slots ``[pos, pos+T)`` (the JAX version returns an updated copy),
    quantizing first for an int8 entry.  ``pos`` is a Python int, a 0-d
    device tensor (the fast-forward loop's write position, written by
    ``index_copy_`` so the host never reads it), or a ``[B]`` tensor of
    per-row slots (:func:`_write_cache_rows`).  A paged entry writes
    through its block table (:func:`~bcg_tpu_torch.ops.paged_attention.paged_write`).
    ``seq0``: the entry is an sp slice holding slots ``[seq0, seq0 +
    S_local)``: only the slots it owns are written (a device position
    through :func:`_write_cache_owned`, with no host read)."""
    if is_paged(entry):
        return paged_write(entry, k, v, pos)
    if seq0 is not None and isinstance(pos, torch.Tensor):
        return _write_cache_owned(entry, k, v, pos, seq0)
    if seq0 is not None:
        lo = max(pos, seq0)
        hi = min(pos + k.shape[1], seq0 + _cache_len(entry))
        if hi <= lo:
            return entry
        k, v, pos = k[:, lo - pos:hi - pos], v[:, lo - pos:hi - pos], lo - seq0
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return _write_cache_rows(entry, k, v, pos)
    T = k.shape[1]
    if "k_scale" in entry:
        quant = _kv_quantizer(entry)
        kq, ksc = quant(k)     # [B, T, Hkv, Dh(/2)] int8, [B, T, Hkv]
        vq, vsc = quant(v)
        # Storage is [B, Hkv, S, Dh] / [B, Hkv, S]: S is dim 2.
        writes = ((entry["k"], kq.transpose(1, 2)), (entry["v"], vq.transpose(1, 2)),
                  (entry["k_scale"], ksc.transpose(1, 2)),
                  (entry["v_scale"], vsc.transpose(1, 2)))
        dim = 2
    else:
        writes = ((entry["k"], k.to(entry["k"].dtype)), (entry["v"], v.to(entry["v"].dtype)))
        dim = 1
    if isinstance(pos, torch.Tensor):
        idx = pos.long() + torch.arange(T, device=k.device)
        for dst, src in writes:
            dst.index_copy_(dim, idx, src)
    else:
        for dst, src in writes:
            dst.narrow(dim, pos, T).copy_(src)
    return entry


def _write_cache_owned(entry: Dict, k, v, pos, seq0: int) -> Dict:
    """Write a ``[B, T]`` chunk at the device position ``pos`` (0-d: the
    fast-forward loop's; ``[B]``: the speculative loop's per-row slots)
    into an sp slice holding slots ``[seq0, seq0 + S_local)``, keeping only
    the slots it owns.  Every chunk slot maps to a distinct local slot
    (its offset modulo ``S_local``; ``T <= S_local``), where a slot the
    rank does not own is rewritten with its own old value: one gather and
    one write, and the position never goes to the host."""
    B, T = k.shape[0], k.shape[1]
    S = _cache_len(entry)
    if T > S:
        raise ValueError(f"a {T}-slot write into an sp slice of {S} slots")
    j = torch.arange(T, device=k.device)
    rel = (pos.long() - seq0)
    sidx = (rel[:, None] if rel.ndim == 1 else rel[None, None]) + j[None, :]
    sidx = sidx.expand(B, T)
    own = (sidx >= 0) & (sidx < S)
    sidx = sidx.remainder(S)
    bidx = torch.arange(B, device=k.device)[:, None]
    if "k_scale" in entry:
        quant = _kv_quantizer(entry)
        kq, ksc = quant(k)
        vq, vsc = quant(v)
        # [B, Hkv, S, *] indexed on dims (0, 2): the region is [B, T, Hkv, *].
        for name, new in (("k", kq), ("v", vq), ("k_scale", ksc), ("v_scale", vsc)):
            dst = entry[name]
            keep = own.view(B, T, *([1] * (new.dim() - 2)))
            dst[bidx, :, sidx] = torch.where(keep, new, dst[bidx, :, sidx])
    else:
        for name, new in (("k", k), ("v", v)):
            dst = entry[name]
            dst[bidx, sidx] = torch.where(own[..., None, None], new.to(dst.dtype),
                                          dst[bidx, sidx])
    return entry


def _write_cache_rows(entry: Dict, k, v, row_pos) -> Dict:
    """Per-row-position variant: row ``b``'s ``[T]``-token chunk lands at
    slots ``[row_pos[b], row_pos[b]+T)``, in place (the speculative loop,
    whose rows advance by their own accepted counts)."""
    B, T = k.shape[0], k.shape[1]
    bidx = torch.arange(B, device=k.device)[:, None]
    sidx = row_pos.long()[:, None] + torch.arange(T, device=k.device)[None, :]
    if "k_scale" in entry:
        quant = _kv_quantizer(entry)
        kq, ksc = quant(k)
        vq, vsc = quant(v)
        # Advanced indices on dims (0, 2) of [B, Hkv, S, Dh] move to the
        # front: the target region is [B, T, Hkv, Dh] — the fresh layout.
        entry["k"][bidx, :, sidx] = kq
        entry["v"][bidx, :, sidx] = vq
        entry["k_scale"][bidx, :, sidx] = ksc
        entry["v_scale"][bidx, :, sidx] = vsc
    else:
        entry["k"][bidx, sidx] = k.to(entry["k"].dtype)
        entry["v"][bidx, sidx] = v.to(entry["v"].dtype)
    return entry


def _cache_attention(q, entry: Dict, mask, scale, plan=None):
    """Decode-step attention over the cache through the decode kernels'
    wrappers: a paged entry through the paged kernel; a dense int4 entry
    dequantized whole to bf16 (as the JAX package does: it has no dense
    int4 kernel) and through the bf16 kernel.  q: [B, 1, H, Dh]; mask:
    [B, S]; ``plan``: the kernels' split plan shape under a mesh
    (``ModelParallel.decode_plan``)."""
    if is_paged(entry):
        return paged_decode_attention(q, entry, mask, scale, plan)
    if kv_is_int4(entry):
        k, v = _dequant_view(entry, q.dtype)
        return decode_attention(q[:, 0], k, v, mask, scale, plan)[:, None]
    if "k_scale" in entry:
        return decode_attention_int8(q[:, 0], entry["k"], entry["v"], entry["k_scale"],
                                     entry["v_scale"], mask, scale, plan)[:, None]
    return decode_attention(q[:, 0], entry["k"], entry["v"], mask, scale, plan)[:, None]


def _cache_len(cache) -> int:
    """Allocated cache length S across layouts: bf16 k is [B, S, Hkv, Dh],
    quantized k is [B, Hkv, S, Dh(/2)], a paged entry's S is its table
    width times the block size."""
    entry = cache if isinstance(cache, dict) else cache[0]
    if is_paged(entry):
        return entry["tbl"].shape[1] * paged_block_size(entry)
    return entry["k"].shape[-2 if "k_scale" in entry else -3]


def _dequant_slice(entry: Dict, name: str, upto: int, dtype) -> torch.Tensor:
    """Cache slots [0, upto) of k or v as [B, upto, Hkv, Dh] in ``dtype``,
    dequantized out of the int8 or int4 layout when stored quantized.  A
    paged entry gathers the table's first ``upto / bs`` columns first
    (the caller block-aligns the history window)."""
    if is_paged(entry):
        bs = paged_block_size(entry)
        if upto % bs:
            raise ValueError(f"paged history window {upto} not block-aligned (bs={bs})")
        entry = paged_gather_entry(entry, upto_blocks=upto // bs)
    scale_name = f"{name}_scale"
    if scale_name not in entry:
        return entry[name][:, :upto].to(dtype)
    return _kv_dequantizer(entry)(
        entry[name][:, :, :upto], entry[scale_name][:, :, :upto]
    ).to(dtype).transpose(1, 2)


def _block(
    layer: Dict,
    spec: ModelSpec,
    x: torch.Tensor,          # [B, T, D]
    cos: torch.Tensor,
    sin: torch.Tensor,
    kv_write_pos: int,        # where in the cache to write
    cache_entry: Dict,        # {k, v} [B, S, Hkv, Dh]
    attn_mask: torch.Tensor,  # prefill: [B, T, hist_len+T]; decode: [B, S]
    hist_len: int = 0,        # cache slots [0, hist_len) hold a reusable prefix
    seq0: Optional[int] = None,  # the entry is an sp slice from this slot
    ring: Optional[str] = None,  # "prefill": x is this rank's block of the
                                 # prompt; "cache": decode over an sp slice
    kv_valid: Optional[torch.Tensor] = None,  # [B, T] of the block (ring prefill)
    dp_write: bool = False,      # a paged write of dp-split rows: every rank's
                                 # rows' k/v go into every rank's pool
) -> Tuple[torch.Tensor, Dict]:
    B, T, D = x.shape
    par = spec.par
    h = rms_norm(x, layer["attn_norm"], spec.rms_eps)
    route = spec.dense_route
    q, k, v = (dense(h, layer["wq"], route=route), dense(h, layer["wk"], route=route),
               dense(h, layer["wv"], route=route))
    if "bq" in layer:  # Qwen2-style projection biases
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    # Local head counts under tp: the products' widths say them.
    q = q.reshape(B, T, -1, spec.head_dim)
    k = k.reshape(B, T, -1, spec.head_dim)
    v = v.reshape(B, T, -1, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, layer["q_norm"], spec.rms_eps)
        k = rms_norm(k, layer["k_norm"], spec.rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if ring == "prefill":
        # The whole prompt's k/v, for the owners of its slots.
        kw, vw = (all_gather(t, par.mesh, "sp", dim=1) for t in (k, v))
        entry = _write_cache(cache_entry, kw, vw, kv_write_pos, seq0)
    elif dp_write:
        entry = _write_cache(cache_entry, *(all_gather(t, par.mesh, "dp") for t in (k, v)),
                             kv_write_pos)
    else:
        entry = _write_cache(cache_entry, k, v, kv_write_pos, seq0)
    sel = _kv_selector(par)

    scale = 1.0 / math.sqrt(spec.head_dim)
    if ring == "prefill":
        from bcg_tpu_torch.ops.ring_attention import ring_attention

        attn_out = ring_attention(q, sel(k), sel(v), par.mesh, causal=True, scale=scale,
                                  kv_valid=kv_valid)
    elif ring == "cache":
        if T > 1:
            raise ValueError("a prefill into an sp-split cache goes through prefill_sp "
                             "or prefill_chunk_at")
        from bcg_tpu_torch.ops.ring_attention import sp_decode_attention

        ck, cv, scales = _sp_slice_kv(par, entry)
        attn_out = sp_decode_attention(q[:, 0], ck, cv, attn_mask, par.mesh, scale=scale,
                                       **scales)[:, None]
    elif T > 1 and hist_len > 0:
        # Suffix prefill: the chunk attends over the cached prefix KV plus
        # itself.  When the chunk was just written right behind the
        # prefix and the cache holds q's dtype, the cache slots
        # [0, hist_len+T) ARE the concatenation — read them in place
        # (strided, no copy).  Otherwise concatenate like the JAX code
        # (an int8 history dequantized; the chunk's own KV unquantized).
        ck, cv = entry["k"], entry["v"]
        if not is_paged(entry) and kv_write_pos == hist_len and ck.dtype == q.dtype:
            hk, hv = ck[:, :hist_len + T], cv[:, :hist_len + T]
        else:
            hk = torch.cat([_dequant_slice(entry, "k", hist_len, q.dtype), k], dim=1)
            hv = torch.cat([_dequant_slice(entry, "v", hist_len, q.dtype), v], dim=1)
        attn_out = attention(q, sel(hk), sel(hv), attn_mask, scale)
    elif T > 1:
        # Full prefill attends over the FRESH chunk only.
        attn_out = attention(q, sel(k), sel(v), attn_mask, scale)
    else:
        attn_out = _cache_attention(q, _local_entry(par, entry), attn_mask, scale,
                                    par.decode_plan(B) if par is not None else None)
    return _block_out(layer, spec, x, attn_out), entry


def _row_parallel(x: torch.Tensor, w, spec, split: bool) -> torch.Tensor:
    """``dense(x, w)`` of a row-parallel weight.  Where ``tp`` splits it,
    each rank's partial product is taken in f32, summed over ``tp`` in
    f32 and rounded once to the product's type — as one device's product
    is rounded once; a quantized weight goes through
    :func:`~bcg_tpu_torch.models.quantize.dense_row_parallel` (W8A8: the
    whole row's activation scale and an exact int32 sum)."""
    par = spec.par
    if par is None or not split:
        return dense(x, w, route=spec.dense_route)
    if isinstance(w, dict):
        from bcg_tpu_torch.models.quantize import dense_row_parallel

        return dense_row_parallel(x, w, par.mesh, route=spec.dense_route).to(x.dtype)
    if x.dtype == w.dtype == torch.bfloat16:
        # The bf16 product's f32 accumulator itself, not its bf16 rounding.
        from bcg_tpu_torch.models.quantize import bf16_product_f32

        part = bf16_product_f32(x, w)
    else:
        part = dense(x, w, torch.float32, route=spec.dense_route)
    return all_reduce(part, par.mesh, "tp").to(x.dtype)


def _block_out(layer, spec, x, attn_out):
    """The block after attention: ``wo`` and the SwiGLU MLP, each
    row-parallel product summed over ``tp`` under a mesh."""
    B, T = x.shape[:2]
    route = spec.dense_route
    par = spec.par
    x = x + _row_parallel(attn_out.reshape(B, T, -1), layer["wo"], spec,
                          par is not None and par.heads_split)
    h = rms_norm(x, layer["mlp_norm"], spec.rms_eps)
    gate = F.silu(dense(h, layer["w_gate"], route=route))
    return x + _row_parallel(gate * dense(h, layer["w_up"], route=route), layer["w_down"],
                             spec, par is not None and par.mlp_split)


def _kv_selector(par):
    """``t ->`` the kv heads this rank's q heads read (a view over heads,
    which the kernels take), or the identity."""
    if par is None or par.kv_sel is None:
        return lambda t: t
    return par.select_kv


def _local_entry(par, entry: Dict) -> Dict:
    """A cache entry (dense or paged, any layout) narrowed to the kv heads
    this rank's q heads read: heads are dim 2 of bf16 k/v and dim 1 of
    quantized k/v and their scales."""
    if par is None or par.kv_sel is None:
        return entry
    out = dict(entry)
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in entry:
            out[name] = par.select_kv(entry[name], 1 if "k_scale" in entry else 2)
    return out


def _sp_slice_kv(par, entry: Dict):
    """``(k, v, scales)`` of an sp slice for the slices' merge
    (``ops/ring_attention``): bf16 ``[B, S/sp, Hkv, Dh]``, or int8 ``[B,
    Hkv, S/sp, Dh]`` with its ``k_scale``/``v_scale`` (dequantized in the
    merge, on the rank)."""
    e = _local_entry(par, entry)
    if "k_scale" in e:
        return e["k"], e["v"], {"k_scale": e["k_scale"], "v_scale": e["v_scale"]}
    return e["k"], e["v"], {}


def _run_layers(params, spec, x, cos, sin, write_pos, cache, attn_mask,
                hist_len: int = 0, ring: Optional[str] = None, kv_valid=None):
    """Apply every decoder block in order (a Python loop: PyTorch runs
    eagerly, so there is no program-size reason to scan).  A paged
    cache's write index is worked out once for all layers; over an
    sp-split cache a decode step attends its slice (``ring="cache"``),
    through the slice's columns of ``attn_mask``."""
    write_pos, dp_write = _paged_index(spec, cache, x.shape[1], write_pos)
    seq0 = getattr(cache, "seq0", None)
    if ring is None and seq0 is not None:
        ring = "cache"
        attn_mask = attn_mask[..., seq0:seq0 + _cache_len(cache[0])]
    for li in range(spec.num_layers):
        x, _ = _block(
            _layer(params, li), spec, x, cos, sin, write_pos, cache[li],
            attn_mask, hist_len=hist_len, seq0=seq0, ring=ring, kv_valid=kv_valid,
            dp_write=dp_write,
        )
    return x, cache


def _paged_index(spec, cache, T: int, write_pos):
    """A paged cache's write index, worked out once for every layer, and
    whether its writes gather the rows of every ``dp`` rank (a paged
    batch split over ``dp``, ``PagedCache.dp_split``: the pool replicates
    over ``dp``, so every rank writes every row, as GSPMD writes a
    replicated pool from dp-sharded rows).  A dense cache's position is
    returned as it is."""
    if not is_paged(cache[0]):
        return write_pos, False
    idx = paged_write_index(cache[0], T, write_pos)
    if not getattr(cache, "dp_split", False):
        return idx, False
    mesh = spec.par.mesh
    return type(idx)(*(all_gather(t, mesh, "dp") for t in idx)), True


def _embed(params, spec, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings; under a vocabulary-split ``tp`` a masked lookup
    in the rank's rows, then one sum (exact: one rank holds each id)."""
    par = spec.par
    if par is None or not par.vocab_split:
        return params["embed"][tokens]
    table = params["embed"]
    ids = tokens - par.tp_rank * table.shape[0]
    own = (ids >= 0) & (ids < table.shape[0])
    x = table[ids.clamp(0, table.shape[0] - 1)] * own[..., None].to(table.dtype)
    return all_reduce(x.float(), par.mesh, "tp").to(table.dtype)


def _logits(params: TransformerParams, spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    """f32 logits; under a vocabulary-split ``tp`` the rank's columns
    gathered along the vocabulary (every rank then holds all of them)."""
    h = rms_norm(x, params["final_norm"], spec.rms_eps)
    if "lm_head" in params:
        out = dense(h, params["lm_head"], torch.float32, route=spec.dense_route)
    elif not spec.tie_embeddings:
        raise KeyError(f"params for untied model {spec.name!r} lack 'lm_head'")
    else:
        hh, ee = _promote(h, params["embed"])
        out = (hh @ ee.T).float()
    par = spec.par
    if par is not None and par.vocab_split:
        out = all_gather(out, par.mesh, "tp", dim=-1)
    return out


def _positions(valid: torch.Tensor, offset=None) -> torch.Tensor:
    pos = torch.cumsum(valid.to(torch.int32), dim=1) - 1
    if offset is not None:
        pos = offset[:, None].to(torch.int32) + pos
    return torch.clamp(pos, min=0)


def _chunk_mask(valid: torch.Tensor) -> torch.Tensor:
    L = valid.shape[1]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=valid.device))
    return causal[None] & valid[:, None, :] & valid[:, :, None]


def prefill(params, spec, tokens, valid, cache) -> Tuple[torch.Tensor, KVCache]:
    """Process the full prompt (``tokens``/``valid`` ``[B, L]``, left-
    padded); writes cache slots ``[0, L)`` in place and returns the
    last-position logits ``[B, V]`` f32 and the cache."""
    positions = _positions(valid)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    x = _embed(params, spec, tokens)
    x, cache = _run_layers(params, spec, x, cos, sin, 0, cache, _chunk_mask(valid))
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


def prefill_sp(params, spec, tokens, valid, cache) -> Tuple[torch.Tensor, KVCache]:
    """Sequence-parallel full-prompt prefill (``tokens``/``valid`` ``[B,
    L]``, left-padded, L divisible by ``sp``): each rank runs its block of
    ``L / sp`` positions through the model, attention goes round the ring
    (:func:`~bcg_tpu_torch.ops.ring_attention.ring_attention`), and the
    prompt's k/v are written to the slots of ``[0, L)`` the rank's cache
    holds.  Returns the last position's logits ``[B, V]`` (on every rank)
    and the cache."""
    from bcg_tpu_torch.ops.ring_attention import shard_seq

    par = spec.par
    positions = _positions(valid)
    blk_tokens, blk_valid, blk_pos = (shard_seq(t, par.mesh) for t in (tokens, valid, positions))
    cos, sin = rope_table(blk_pos, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    x = _embed(params, spec, blk_tokens)
    x, cache = _run_layers(params, spec, x, cos, sin, 0, cache, None, ring="prefill",
                           kv_valid=blk_valid)
    # The last position lies in the last rank's block.
    last = broadcast(x[:, -1:, :].contiguous(), par.mesh, "sp", src=par.sp - 1)
    return _logits(params, spec, last)[:, 0, :], cache


def prefill_with_prefix(params, spec, tokens, valid, cache, prefix_valid,
                        prefix_lens) -> Tuple[torch.Tensor, KVCache]:
    """Prefill the per-call suffix ``[B, Ls]`` against a cached prompt
    prefix in slots ``[0, P)``; RoPE positions continue where each row's
    prefix ended; the suffix KV is written at ``[P, P+Ls)`` in place."""
    P = prefix_valid.shape[1]
    positions = _positions(valid, prefix_lens)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    hist_mask = prefix_valid[:, None, :] & valid[:, :, None]          # [B, Ls, P]
    attn_mask = torch.cat([hist_mask, _chunk_mask(valid)], dim=2)     # [B, Ls, P+Ls]
    x = _embed(params, spec, tokens)
    x, cache = _run_layers(params, spec, x, cos, sin, P, cache, attn_mask,
                           hist_len=P)
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


def prefill_chunk_at(params, spec, tokens, valid, cache, hist_valid,
                     pos_offset, write_pos: int) -> Tuple[torch.Tensor, KVCache]:
    """One chunk ``[B, C]`` of a chunked prefill: attends the fixed
    ``[B, H]`` history window plus itself and writes its KV at
    ``[write_pos, write_pos+C)`` in place.  Into an sp-split cache the
    chunk is written first and then attends the whole cache through its
    ``[B, C, S]`` mask, slice by slice (the decode chunk's sp path)."""
    H = hist_valid.shape[1]
    positions = _positions(valid, pos_offset)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    hist_mask = hist_valid[:, None, :] & valid[:, :, None]
    x = _embed(params, spec, tokens)
    if getattr(cache, "seq0", None) is not None:
        B, C = tokens.shape
        full = torch.zeros((B, C, cache.seq_total), dtype=torch.bool, device=tokens.device)
        full[:, :, :H] = hist_mask
        full[:, :, write_pos:write_pos + C] = _chunk_mask(valid)
        x, cache = _run_chunk_layers(params, spec, x, cos, sin, write_pos, cache, full)
        return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache
    attn_mask = torch.cat([hist_mask, _chunk_mask(valid)], dim=2)
    x, cache = _run_layers(params, spec, x, cos, sin, write_pos, cache,
                           attn_mask, hist_len=H)
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


def _last_valid_logits(params, spec, x, valid) -> torch.Tensor:
    """Logits ``[B, V]`` at each row's last VALID position of a
    right-padded chunk (position 0 for a row with none)."""
    last = (valid.to(torch.int64).sum(dim=1) - 1).clamp(min=0)
    h_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[2]))
    return _logits(params, spec, h_last)[:, 0, :]


def prefill_paged(params, spec, tokens, valid, cache, prefix_valid,
                  prefix_lens) -> Tuple[torch.Tensor, list]:
    """Prefill into a PAGED cache: the chunk ``[B, Ls]`` (the whole prompt
    when ``P == 0``, else the suffix past the radix-resident prefix in
    slots ``[0, P)``) is written at logical slots ``[P, P+Ls)`` through
    each row's block table.  Unlike :func:`prefill_with_prefix`, tokens
    arrive RIGHT-padded (left-aligned, so full real-token blocks can be
    shared) and logits are taken at each row's last VALID position."""
    P = prefix_valid.shape[1]
    positions = _positions(valid, prefix_lens)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    hist_mask = prefix_valid[:, None, :] & valid[:, :, None]          # [B, Ls, P]
    attn_mask = torch.cat([hist_mask, _chunk_mask(valid)], dim=2)     # [B, Ls, P+Ls]
    x = _embed(params, spec, tokens)
    x, cache = _run_layers(params, spec, x, cos, sin, P, cache, attn_mask, hist_len=P)
    return _last_valid_logits(params, spec, x, valid), cache


def prefill_paged_chunk_at(params, spec, tokens, valid, cache, hist_valid, pos_offset,
                           write_pos: int, carry_logits) -> Tuple[torch.Tensor, list]:
    """One RIGHT-padded chunk ``[B, C]`` of a paged chunked prefill: attends
    the block-aligned ``[B, H]`` history window (gathered from the table's
    first ``H / bs`` columns) plus itself, and writes its KV at logical
    slots ``[write_pos, write_pos+C)``.  Rows end in different chunks, so
    the logits of a row with no valid token here stay ``carry_logits``."""
    H = hist_valid.shape[1]
    positions = _positions(valid, pos_offset)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    hist_mask = hist_valid[:, None, :] & valid[:, :, None]
    attn_mask = torch.cat([hist_mask, _chunk_mask(valid)], dim=2)
    x = _embed(params, spec, tokens)
    x, cache = _run_layers(params, spec, x, cos, sin, write_pos, cache, attn_mask,
                           hist_len=H)
    logits = _last_valid_logits(params, spec, x, valid)
    return torch.where(valid.any(dim=1)[:, None], logits, carry_logits), cache


def decode_step(params, spec, token, write_pos: int, seq_positions, cache,
                valid_mask) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step for the whole batch: ``token`` ``[B]`` is
    written at cache slot ``write_pos`` (in place) and attends the
    ``[B, S]`` ``valid_mask`` slots; returns logits ``[B, V]`` f32."""
    cos, sin = rope_table(seq_positions[:, None], spec.head_dim,
                          spec.rope_theta, spec.rope_scaling)
    x = _embed(params, spec, token)[:, None, :]
    x, cache = _run_layers(params, spec, x, cos, sin, write_pos, cache, valid_mask)
    return _logits(params, spec, x)[:, 0, :], cache


def _chunk_mask_at(cache_valid, chunk_valid, write_pos) -> torch.Tensor:
    """``[B, K, S]`` attention mask of a decode chunk: the valid prior
    cache slots plus the causally-visible valid part of the chunk at its
    write slots (a 0-d or Python-int ``write_pos`` shared by the batch, or
    ``[B]`` per-row slots) — built once per step and shared by every
    layer."""
    B, K = chunk_valid.shape
    base = cache_valid[:, None, :].expand(B, K, cache_valid.shape[1]).clone()
    causal = torch.tril(torch.ones((K, K), dtype=torch.bool, device=chunk_valid.device))
    chunk_mask = causal[None] & chunk_valid[:, None, :] & chunk_valid[:, :, None]
    j = torch.arange(K, device=chunk_valid.device)
    if isinstance(write_pos, torch.Tensor) and write_pos.ndim == 1:
        bidx = torch.arange(B, device=chunk_valid.device)[:, None, None]
        sidx = write_pos.long()[:, None, None] + j[None, None, :]
        base[bidx, j[None, :, None], sidx] = chunk_mask
    elif isinstance(write_pos, torch.Tensor):
        base.index_copy_(2, write_pos.long() + j, chunk_mask)
    else:
        base[:, :, write_pos:write_pos + K] = chunk_mask
    return base


def _run_chunk_layers(params, spec, x, cos, sin, write_pos, cache, attn_mask):
    write_pos, dp_write = _paged_index(spec, cache, x.shape[1], write_pos)
    seq0 = getattr(cache, "seq0", None)
    if seq0 is not None:
        attn_mask = attn_mask[..., seq0:seq0 + _cache_len(cache[0])]
    for li in range(spec.num_layers):
        x, _ = _block_chunk(_layer(params, li), spec, x, cos, sin, write_pos,
                            cache[li], attn_mask, seq0=seq0, dp_write=dp_write)
    return x, cache


def decode_chunk(params, spec, tokens, chunk_valid, write_pos, positions, cache,
                 cache_valid) -> Tuple[torch.Tensor, KVCache]:
    """One fast-forward step: a ``[B, K]`` chunk (the sampled token plus
    up to K-1 DFA-forced tokens per row) in one weight pass.  The chunk is
    written at cache slots ``[write_pos, write_pos+K)`` (``write_pos`` a
    Python int or a 0-d device tensor); rows with shorter chains leave
    trailing slots invalid.  ``positions`` ``[B, K]`` are the RoPE
    positions, ``cache_valid`` ``[B, S]`` the attendable slots BEFORE the
    chunk.  Returns the logits at each row's LAST VALID chunk position
    ``[B, V]`` f32 and the cache."""
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    attn_mask = _chunk_mask_at(cache_valid, chunk_valid, write_pos)
    x = _embed(params, spec, tokens)
    x, cache = _run_chunk_layers(params, spec, x, cos, sin, write_pos, cache, attn_mask)
    last = chunk_valid.sum(dim=1) - 1                                   # [B]
    h_last = torch.gather(x, 1, last[:, None, None].expand(-1, 1, x.shape[2]))
    return _logits(params, spec, h_last)[:, 0, :], cache


def decode_chunk_spec(params, spec, tokens, chunk_valid, row_write_pos, positions, cache,
                      cache_valid) -> Tuple[torch.Tensor, KVCache]:
    """One speculative verify step: a ``[B, K1]`` chunk (the sampled token
    plus up to K1-1 drafted tokens) with PER-ROW write slots
    ``row_write_pos`` ``[B]`` (each row's cache stays compacted at its own
    accepted count), returning logits at EVERY chunk position
    ``[B, K1, V]`` — position j's logits score draft token j."""
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    attn_mask = _chunk_mask_at(cache_valid, chunk_valid, row_write_pos)
    x = _embed(params, spec, tokens)
    x, cache = _run_chunk_layers(params, spec, x, cos, sin, row_write_pos, cache, attn_mask)
    return _logits(params, spec, x), cache


def _block_chunk(layer, spec, x, cos, sin, write_pos, cache_entry, attn_mask,
                 seq0: Optional[int] = None, dp_write: bool = False):
    """Chunk decode block: write the fresh K positions into the cache, then
    attend over the WHOLE cache (prior context and the chunk itself, all
    selected by ``attn_mask`` ``[B, K, S]``) through the chunk kernels'
    wrappers (a paged entry through the paged kernel's chunk form; a
    dense int4 entry dequantized to bf16 first; an sp slice of the cache,
    ``seq0``, through the slices' merge with ``attn_mask`` its columns)."""
    B, K, D = x.shape
    par = spec.par
    h = rms_norm(x, layer["attn_norm"], spec.rms_eps)
    route = spec.dense_route
    q, k, v = (dense(h, layer["wq"], route=route), dense(h, layer["wk"], route=route),
               dense(h, layer["wv"], route=route))
    if "bq" in layer:
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(B, K, -1, spec.head_dim)
    k = k.reshape(B, K, -1, spec.head_dim)
    v = v.reshape(B, K, -1, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, layer["q_norm"], spec.rms_eps)
        k = rms_norm(k, layer["k_norm"], spec.rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if dp_write:
        k, v = (all_gather(t, par.mesh, "dp") for t in (k, v))
    entry = _write_cache(cache_entry, k, v, write_pos, seq0)
    scale = 1.0 / math.sqrt(spec.head_dim)
    plan = par.decode_plan(B) if par is not None else None
    if seq0 is not None:
        from bcg_tpu_torch.ops.ring_attention import sp_chunk_decode_attention

        ck, cv, scales = _sp_slice_kv(par, entry)
        attn_out = sp_chunk_decode_attention(q, ck, cv, attn_mask, par.mesh, scale=scale,
                                             **scales)
        return _block_out(layer, spec, x, attn_out), entry
    e = _local_entry(par, entry)
    if is_paged(e):
        attn_out = paged_chunk_attention(q, e, attn_mask, scale, plan)
    elif kv_is_int4(e):
        ck, cv = _dequant_view(e, q.dtype)
        attn_out = chunk_decode_attention(q, ck, cv, attn_mask, scale, plan)
    elif "k_scale" in e:
        attn_out = chunk_decode_attention_int8(q, e["k"], e["v"], e["k_scale"],
                                               e["v_scale"], attn_mask, scale, plan)
    else:
        attn_out = chunk_decode_attention(q, e["k"], e["v"], attn_mask, scale, plan)
    return _block_out(layer, spec, x, attn_out), entry


def param_count(params: TransformerParams) -> int:
    """Elements of every leaf (a quantized leaf's parts summed)."""
    return sum(int(np.prod(t.shape)) for p in params.values()
               for t in (p.values() if isinstance(p, dict) else (p,)))
