"""Functional decoder-only transformer (RMSNorm / RoPE / GQA / SwiGLU) in
PyTorch — the port of ``bcg_tpu/models/transformer.py``.

* Parameters are a flat dict of tensors keyed by :func:`param_plan`'s
  logical names (``"embed"``, ``"layers.3.wq"``, ...); dense weights are
  ``[in, out]`` as in the JAX package, so ``x @ w`` reads the same.
* Prefill is ``[B, L]`` with an explicit validity mask (left-padded
  batches); decode is a ``[B, 1]`` step against a preallocated KV cache.
* Weights and KV cache are bf16 on the served path; RMSNorm accumulates in
  f32; attention softmax runs in f32.  Where the JAX package promotes
  mixed dtypes implicitly (an f32 query against a bf16 cache), this
  module promotes explicitly to the same result type, so f32 weights on
  the CPU reproduce the JAX numbers.
* Attention goes through the hand-written kernels' wrappers
  (:mod:`bcg_tpu_torch.ops.attention` for prefill,
  :mod:`bcg_tpu_torch.ops.decode_attention` for the decode step), which
  launch the CUDA kernel on a CUDA tensor and run the plain version on a
  CPU tensor.
* Where JAX returns a NEW cache, this module writes the cache IN PLACE
  and returns the same entries (see :func:`_write_cache`).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bcg_tpu_torch.models.configs import ModelSpec
from bcg_tpu_torch.ops.attention import flash_attention
from bcg_tpu_torch.ops.decode_attention import decode_attention

TransformerParams = Dict[str, torch.Tensor]  # flat: logical name -> tensor


class KVCache(list):
    """Per-layer ``{"k", "v"}`` dense caches ``[B, S, Hkv, Dh]``, all views
    of ONE buffer ``buf`` ``[num_layers, 2, B, S, Hkv, Dh]`` — one memset
    to allocate, one copy to move a prefix entry into a batch cache."""

    def __init__(self, buf: torch.Tensor):
        super().__init__({"k": buf[li, 0], "v": buf[li, 1]} for li in range(buf.shape[0]))
        self.buf = buf


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


def dense(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` in the promoted type, cast to ``out_dtype`` (default
    ``x``'s dtype) — ``models/quantize.dense``'s bf16 branch."""
    if out_dtype is None:
        out_dtype = x.dtype
    xx, ww = _promote(x, w)
    return (xx @ ww).to(out_dtype)


# ------------------------------------------------------------------ forward

def init_kv_cache(spec: ModelSpec, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu") -> KVCache:
    """Zero-filled dense bf16 cache: per layer ``{"k", "v"}``
    ``[B, S, Hkv, Dh]`` (see :class:`KVCache`)."""
    shape = (batch, max_len, spec.num_kv_heads, spec.head_dim)
    return KVCache(torch.zeros((spec.num_layers, 2) + shape, dtype=dtype, device=device))


def _write_cache(entry: Dict, k, v, pos) -> Dict:
    """Write fresh k/v ``[B, T, Hkv, Dh]`` into the cache entry IN PLACE at
    slots ``[pos, pos+T)`` (the JAX version returns an updated copy).
    ``pos`` is a scalar slot shared by the batch, or a ``[B]`` tensor of
    per-row slots (:func:`_write_cache_rows`)."""
    if isinstance(pos, torch.Tensor) and pos.ndim == 1:
        return _write_cache_rows(entry, k, v, pos)
    T = k.shape[1]
    entry["k"][:, pos:pos + T] = k.to(entry["k"].dtype)
    entry["v"][:, pos:pos + T] = v.to(entry["v"].dtype)
    return entry


def _write_cache_rows(entry: Dict, k, v, row_pos) -> Dict:
    """Per-row-position variant: row ``b``'s ``[T]``-token chunk lands at
    slots ``[row_pos[b], row_pos[b]+T)``, in place."""
    B, T = k.shape[0], k.shape[1]
    bidx = torch.arange(B, device=k.device)[:, None]
    sidx = row_pos.long()[:, None] + torch.arange(T, device=k.device)[None, :]
    entry["k"][bidx, sidx] = k.to(entry["k"].dtype)
    entry["v"][bidx, sidx] = v.to(entry["v"].dtype)
    return entry


def _cache_attention(q, entry: Dict, mask, scale):
    """Decode-step attention over the bf16 cache through the decode
    kernel's wrapper.  q: [B, 1, H, Dh]; mask: [B, S] attendable slots."""
    return decode_attention(q[:, 0], entry["k"], entry["v"], mask, scale)[:, None]


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
) -> Tuple[torch.Tensor, Dict]:
    B, T, D = x.shape
    h = rms_norm(x, layer["attn_norm"], spec.rms_eps)
    q, k, v = dense(h, layer["wq"]), dense(h, layer["wk"]), dense(h, layer["wv"])
    if "bq" in layer:  # Qwen2-style projection biases
        q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
    q = q.reshape(B, T, spec.num_heads, spec.head_dim)
    k = k.reshape(B, T, spec.num_kv_heads, spec.head_dim)
    v = v.reshape(B, T, spec.num_kv_heads, spec.head_dim)
    if spec.qk_norm:
        q = rms_norm(q, layer["q_norm"], spec.rms_eps)
        k = rms_norm(k, layer["k_norm"], spec.rms_eps)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    entry = _write_cache(cache_entry, k, v, kv_write_pos)

    scale = 1.0 / math.sqrt(spec.head_dim)
    if T > 1 and hist_len > 0:
        # Suffix prefill: the chunk attends over the cached prefix KV plus
        # itself.  When the chunk was just written right behind the
        # prefix and the cache holds q's dtype, the cache slots
        # [0, hist_len+T) ARE the concatenation — read them in place
        # (strided, no copy).  Otherwise concatenate like the JAX code.
        ck, cv = entry["k"], entry["v"]
        if kv_write_pos == hist_len and ck.dtype == q.dtype:
            hk, hv = ck[:, :hist_len + T], cv[:, :hist_len + T]
        else:
            hk = torch.cat([ck[:, :hist_len].to(q.dtype), k], dim=1)
            hv = torch.cat([cv[:, :hist_len].to(q.dtype), v], dim=1)
        attn_out = attention(q, hk, hv, attn_mask, scale)
    elif T > 1:
        # Full prefill attends over the FRESH chunk only.
        attn_out = attention(q, k, v, attn_mask, scale)
    else:
        attn_out = _cache_attention(q, entry, attn_mask, scale)
    x = x + dense(attn_out.reshape(B, T, spec.q_size), layer["wo"])

    h = rms_norm(x, layer["mlp_norm"], spec.rms_eps)
    gate = F.silu(dense(h, layer["w_gate"]))
    x = x + dense(gate * dense(h, layer["w_up"]), layer["w_down"])
    return x, entry


def _run_layers(params, spec, x, cos, sin, write_pos, cache, attn_mask,
                hist_len: int = 0):
    """Apply every decoder block in order (a Python loop: PyTorch runs
    eagerly, so there is no program-size reason to scan)."""
    for li in range(spec.num_layers):
        x, _ = _block(
            _layer(params, li), spec, x, cos, sin, write_pos, cache[li],
            attn_mask, hist_len=hist_len,
        )
    return x, cache


def _logits(params: TransformerParams, spec: ModelSpec, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, params["final_norm"], spec.rms_eps)
    if "lm_head" in params:
        return dense(h, params["lm_head"], out_dtype=torch.float32)
    if not spec.tie_embeddings:
        raise KeyError(f"params for untied model {spec.name!r} lack 'lm_head'")
    hh, ee = _promote(h, params["embed"])
    return (hh @ ee.T).float()


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
    x = params["embed"][tokens]
    x, cache = _run_layers(params, spec, x, cos, sin, 0, cache, _chunk_mask(valid))
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


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
    x = params["embed"][tokens]
    x, cache = _run_layers(params, spec, x, cos, sin, P, cache, attn_mask,
                           hist_len=P)
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


def prefill_chunk_at(params, spec, tokens, valid, cache, hist_valid,
                     pos_offset, write_pos: int) -> Tuple[torch.Tensor, KVCache]:
    """One chunk ``[B, C]`` of a chunked prefill: attends the fixed
    ``[B, H]`` history window plus itself and writes its KV at
    ``[write_pos, write_pos+C)`` in place."""
    H = hist_valid.shape[1]
    positions = _positions(valid, pos_offset)
    cos, sin = rope_table(positions, spec.head_dim, spec.rope_theta, spec.rope_scaling)
    hist_mask = hist_valid[:, None, :] & valid[:, :, None]
    attn_mask = torch.cat([hist_mask, _chunk_mask(valid)], dim=2)
    x = params["embed"][tokens]
    x, cache = _run_layers(params, spec, x, cos, sin, write_pos, cache,
                           attn_mask, hist_len=H)
    return _logits(params, spec, x[:, -1:, :])[:, 0, :], cache


def decode_step(params, spec, token, write_pos: int, seq_positions, cache,
                valid_mask) -> Tuple[torch.Tensor, KVCache]:
    """One autoregressive step for the whole batch: ``token`` ``[B]`` is
    written at cache slot ``write_pos`` (in place) and attends the
    ``[B, S]`` ``valid_mask`` slots; returns logits ``[B, V]`` f32."""
    cos, sin = rope_table(seq_positions[:, None], spec.head_dim,
                          spec.rope_theta, spec.rope_scaling)
    x = params["embed"][token][:, None, :]
    x, cache = _run_layers(params, spec, x, cos, sin, write_pos, cache, valid_mask)
    return _logits(params, spec, x)[:, 0, :], cache


def param_count(params: TransformerParams) -> int:
    return sum(int(np.prod(p.shape)) for p in params.values())
