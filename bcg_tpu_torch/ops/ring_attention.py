"""Sequence-parallel exact attention over the ``sp`` mesh axis — the port
of ``bcg_tpu/ops/ring_attention.py``.

The JAX functions take global arrays and shard them in a ``shard_map``;
these take the calling rank's LOCAL shards (its sequence block, and its
batch rows and heads where ``dp`` and ``tp`` split them) and talk to the
other ``sp`` ranks through :mod:`bcg_tpu_torch.parallel.collectives`.  As
in the reference they are plain tensor math, not kernels, on every
device: products in f32 (the reference's ``preferred_element_type``),
probabilities rounded to ``v``'s type before the second product.

* :func:`ring_attention`: full-prompt attention; k/v blocks (and their
  validity) go round the ring with one ``batch_isend_irecv`` a step while
  each rank's queries keep a running max and sum in f32.
* :func:`sp_chunk_decode_attention` / :func:`sp_decode_attention`: decode
  queries against the rank's slice of a sequence-sharded cache (int8
  dequantized locally), the partials merged with one max and two sum
  ``all_reduce``s.  A slice with no attendable slot contributes ``-inf``
  to the max, never a 0 sentinel.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from bcg_tpu_torch.parallel.collectives import all_reduce, axis_rank, axis_size, ring_shift

_NEG_INF = float("-inf")
# Decode-chunk queries scored at once (bounds the [B, block, H, S/sp] scores).
_QUERY_BLOCK = 128


def shard_seq(x: torch.Tensor, mesh, axis_name: str = "sp", dim: int = 1) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a view); the length must
    divide the axis."""
    sp = axis_size(mesh, axis_name)
    if x.shape[dim] % sp:
        raise ValueError(f"sequence length {x.shape[dim]} not divisible by {axis_name}={sp}")
    n = x.shape[dim] // sp
    return x.narrow(dim, axis_rank(mesh, axis_name) * n, n)


def _finite_or_zero(m: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(m), m, torch.zeros_like(m))


def _block_attend(q, k, v, q_pos, k_pos, scale, causal, kv_valid=None):
    """One q-block x kv-block partial: q ``[B, Tq, H, Dh]``, k/v ``[B, Tk,
    Hkv, Dh]``, kv_valid ``[B, Tk]`` (False = pad).  Returns the block max
    and exp-sum ``[B, Hkv, G, Tq]`` (max ``-inf`` where nothing is
    attendable) and the accumulator ``[B, Tq, Hkv, G, Dh]``, f32."""
    B, Tq, H, Dh = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Tq, Hkv, H // Hkv, Dh).float()
    logits = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        logits = logits.masked_fill(~mask[None, None, None], _NEG_INF)
    if kv_valid is not None:
        logits = logits.masked_fill(~kv_valid[:, None, None, None, :], _NEG_INF)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - _finite_or_zero(m)[..., None])
    p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return m, l, acc


def ring_attention(q, k, v, mesh, axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None,
                   kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention with the sequence split over ``axis_name``: ``q``,
    ``k``, ``v`` are this rank's block ``[B, T/sp, H(kv), Dh]`` (rank i
    holds positions ``[i T/sp, (i+1) T/sp)``), ``kv_valid`` its ``[B,
    T/sp]`` validity.  Causality is by position; fully masked query rows
    output 0.  Returns the rank's output block in q's dtype."""
    sp = axis_size(mesh, axis_name)
    me = axis_rank(mesh, axis_name)
    B, Tb, H, Dh = q.shape
    Hkv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    dev = q.device
    q_pos = me * Tb + torch.arange(Tb, device=dev)
    m = torch.full((B, Hkv, H // Hkv, Tb), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Tb, Hkv, H // Hkv, Dh), dtype=torch.float32, device=dev)
    blocks: List[torch.Tensor] = [k, v] + ([kv_valid] if kv_valid is not None else [])
    for s in range(sp):
        # After s shifts this rank holds the block of rank (me - s) mod sp.
        k_pos = ((me - s) % sp) * Tb + torch.arange(blocks[0].shape[1], device=dev)
        bm, bl, bacc = _block_attend(q, blocks[0], blocks[1], q_pos, k_pos, scale, causal,
                                     blocks[2] if kv_valid is not None else None)
        new_m = torch.maximum(m, bm)
        safe = _finite_or_zero(new_m)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - safe), torch.zeros_like(m))
        beta = torch.where(torch.isfinite(bm), torch.exp(bm - safe), torch.zeros_like(bm))
        l = l * alpha + bl * beta
        acc = (acc * alpha.permute(0, 3, 1, 2)[..., None]
               + bacc * beta.permute(0, 3, 1, 2)[..., None])
        m = new_m
        if s < sp - 1:
            blocks = ring_shift(blocks, mesh, axis_name)
    out = acc / torch.clamp_min(l.permute(0, 3, 1, 2)[..., None], 1e-30)
    return out.reshape(B, Tb, H, Dh).to(q.dtype)


def sp_chunk_decode_attention(q, k, v, mask, mesh, axis_name: str = "sp",
                              scale: Optional[float] = None,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A chunk of decode queries ``q`` ``[B, K, H, Dh]`` (every ``sp`` rank
    holds all of them) against this rank's cache slice ``k``/``v`` ``[B,
    S/sp, Hkv, Dh]`` (int8: ``[B, Hkv, S/sp, Dh]`` with ``k_scale``/
    ``v_scale`` ``[B, Hkv, S/sp]``, dequantized here, locally), ``mask``
    ``[B, K, S/sp]`` the attendable slots of the slice.  The slices'
    partials merge in f32: one max and two sum ``all_reduce``s of
    ``[B, K, Hkv, G]``-sized statistics; the cache never moves.  The
    mask carries where the chunk was written (the fast-forward loop's
    0-d device position, the speculative verify's per-row positions:
    ``transformer._chunk_mask_at``), so every decode loop attends through
    this one form."""
    B, K, H, Dh = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    if k_scale is not None:
        from bcg_tpu_torch.ops.decode_attention import dequantize_kv

        k = dequantize_kv(k, k_scale).to(q.dtype).transpose(1, 2)
        v = dequantize_kv(v, v_scale).to(q.dtype).transpose(1, 2)
    Hkv = k.shape[2]
    qg = q.reshape(B, K, Hkv, H // Hkv, Dh).float()
    kf, vf = k.float(), v.float()
    # The local partials a block of queries at a time: the scores of a
    # prefix-cached suffix (K in the thousands) against a long slice would
    # not fit the card at once.
    m_loc, l_loc, acc_loc = [], [], []
    for k0 in range(0, K, _QUERY_BLOCK):
        logits = torch.einsum("bkhgd,bshd->bkhgs", qg[:, k0:k0 + _QUERY_BLOCK], kf) * scale
        logits = logits.masked_fill(~mask[:, k0:k0 + _QUERY_BLOCK, None, None, :], _NEG_INF)
        m = logits.amax(dim=-1)
        p = torch.exp(logits - _finite_or_zero(m)[..., None])
        p = torch.where(torch.isfinite(logits), p, torch.zeros_like(p))
        m_loc.append(m)
        l_loc.append(p.sum(dim=-1))
        acc_loc.append(torch.einsum("bkhgs,bshd->bkhgd", p.to(v.dtype).float(), vf))
        del logits, p
    m_loc, l_loc, acc_loc = (torch.cat(t, dim=1) for t in (m_loc, l_loc, acc_loc))
    m_glob = _finite_or_zero(all_reduce(m_loc.clone(), mesh, axis_name, op="max"))
    corr = torch.where(torch.isfinite(m_loc), torch.exp(m_loc - m_glob),
                       torch.zeros_like(m_loc))
    l = all_reduce(l_loc * corr, mesh, axis_name)
    acc = all_reduce(acc_loc * corr[..., None], mesh, axis_name)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, K, H, Dh).to(q.dtype)


def sp_decode_attention(q, k, v, mask, mesh, axis_name: str = "sp",
                        scale: Optional[float] = None,
                        k_scale: Optional[torch.Tensor] = None,
                        v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step: ``q`` ``[B, H, Dh]``, ``mask`` ``[B, S/sp]`` (the
    K = 1 case of :func:`sp_chunk_decode_attention`)."""
    return sp_chunk_decode_attention(
        q[:, None], k, v, mask[:, None, :], mesh, axis_name=axis_name, scale=scale,
        k_scale=k_scale, v_scale=v_scale,
    )[:, 0]
