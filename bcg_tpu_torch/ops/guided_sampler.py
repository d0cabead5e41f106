"""Fused guided sampler: the kernel's wrapper and its plain version.

Port of ``bcg_tpu/ops/guided_sampler.py``.  Every decode step runs the
guided sampler over the whole ``[B, V]`` logits: the DFA allowed-mask
(a ``min_budget[dfa, state]`` row), the EOS gate, temperature, the
top-p cutoff by bisection of the kept mass, and the greedy argmax or the
inverse-CDF draw — one block per row in ``csrc/guided_sampler.cu``.

:func:`sample_rows` is the kernel-level function (``[token, any_tok]``
per row from explicit per-row scalars, ``u`` included);
:func:`sample_rows_plain` is its plain PyTorch transcription of the TPU
kernel's arithmetic.  :func:`make_fused_sampler` builds the engine-level
closure with ``make_masked_sampler``'s contract: it draws ``u`` from an
explicit ``torch.Generator`` on the logits' device, applies the
dead-end EOS override and the DFA transition.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bcg_tpu_torch.ops import _build

_NEG_INF = -1e30
_LANES = 128
# Bisection iteration counts and the top-p log-prob range — the TPU
# kernel's constants (fp32-exact threshold at 30; ceil(log2 V) <= 21).
_TOPP_ITERS = 30
_CDF_ITERS = 21
_TOPP_RANGE = 30.0
_P, _I = ctypes.c_void_p, ctypes.c_int
# logits, min_budget, dfa_ids, states, meta_i, meta_f, out, B, V, Vp,
# n_states, eos_id, top_p, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P]


def vocab_rows(V: int):
    """(padded vocab, lane rows) of the TPU kernel's ``[Vs, 128]`` row
    layout; the padded width sets the CDF search's upper end."""
    Vp = -(-V // _LANES) * _LANES
    return Vp, Vp // _LANES


def sample_rows_plain(logits, min_budget, dfa_ids, states, meta_i, meta_f,
                      eos_id: int, top_p: float):
    """Plain PyTorch version of the kernel.  ``logits`` ``[B, V]`` f32;
    ``min_budget`` ``[n_dfa, n_states, V]`` int16; ``dfa_ids``/``states``
    ``[B]`` (states clamped >= 0); ``meta_i`` ``[B, 4]`` int32
    ``[budget_left, forbid, greedy, eos_ok]``; ``meta_f`` ``[B, 2]`` f32
    ``[temp, u]``.  Returns ``(token [B] int32, any_tok [B] bool)``."""
    B, V = logits.shape
    Vp, _ = vocab_rows(V)
    dev = logits.device
    lg = logits.float()
    mb = min_budget[dfa_ids.long(), states.long()].to(torch.int32)
    if Vp != V:
        lg = torch.nn.functional.pad(lg, (0, Vp - V))
        mb = torch.nn.functional.pad(mb, (0, Vp - V), value=torch.iinfo(torch.int16).max)
    vid = torch.arange(Vp, device=dev)
    budget_left, forbid = meta_i[:, 0:1], meta_i[:, 1:2]
    greedy, eos_ok = meta_i[:, 2], meta_i[:, 3:4]
    temp, u = meta_f[:, 0:1].float(), meta_f[:, 1].float()
    allowed = (mb <= budget_left) & (vid < V)
    any_tok = allowed.any(dim=-1)
    scaled = lg / temp
    gate = torch.where(vid == eos_id, eos_ok > 0, allowed)
    x = torch.where(gate, scaled, torch.tensor(_NEG_INF, device=dev))
    is_forbid = (vid == forbid) & (forbid >= 0)
    m = x.max(dim=-1, keepdim=True).values
    live = x > _NEG_INF * 0.5
    e = torch.where(live, torch.exp(x - m), torch.zeros((), device=dev))
    if top_p < 1.0:
        t_mass = top_p * e.sum(dim=-1)
        lo = torch.full((B,), -_TOPP_RANGE, dtype=torch.float32, device=dev)
        hi = torch.full((B,), 1e-6, dtype=torch.float32, device=dev)
        for _ in range(_TOPP_ITERS):
            mid = 0.5 * (lo + hi)
            mass = torch.where(x - m >= mid[:, None], e, 0.0).sum(dim=-1)
            keep = mass >= t_mass
            lo, hi = torch.where(keep, mid, lo), torch.where(keep, hi, mid)
        kept = (x - m) >= lo[:, None]
    else:
        kept = live
    sel = kept & ~is_forbid
    xg = torch.where(sel, x, torch.tensor(_NEG_INF, device=dev))
    amax = xg.max(dim=-1, keepdim=True).values
    greedy_tok = torch.where(sel & (xg == amax), vid.float(),
                             torch.tensor(float(2 ** 24), device=dev)).min(dim=-1).values
    w = torch.where(sel, e, 0.0)
    target = u * w.sum(dim=-1)
    lo_i = torch.full((B,), -1, dtype=torch.int64, device=dev)
    hi_i = torch.full((B,), Vp - 1, dtype=torch.int64, device=dev)
    for _ in range(_CDF_ITERS):
        mid = torch.div(lo_i + hi_i, 2, rounding_mode="floor")
        below = torch.where(vid[None, :] <= mid[:, None], w, 0.0).sum(dim=-1)
        up = below > target
        lo_i, hi_i = torch.where(up, lo_i, mid), torch.where(up, mid, hi_i)
    tok = torch.where(greedy > 0, greedy_tok.long(), hi_i)
    return tok.to(torch.int32), any_tok


def _check(logits, min_budget, dfa_ids, states, meta_i, meta_f):
    B, V = logits.shape
    want = [
        (logits, torch.float32, (B, V)), (dfa_ids, torch.int32, (B,)),
        (states, torch.int32, (B,)), (meta_i, torch.int32, (B, 4)),
        (meta_f, torch.float32, (B, 2)),
    ]
    for t, dt, shape in want:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"guided_sampler kernel takes contiguous {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if min_budget.dtype != torch.int16 or min_budget.dim() != 3 \
            or min_budget.shape[2] != V or not min_budget.is_contiguous():
        raise ValueError(f"guided_sampler kernel takes a contiguous int16 min_budget "
                         f"[n_dfa, n_states, {V}], got {min_budget.dtype} "
                         f"{tuple(min_budget.shape)}")
    for t in (min_budget, dfa_ids, states, meta_i, meta_f):
        if t.device != logits.device:
            raise ValueError("guided_sampler: tensors on different devices")


def sample_rows_cuda(logits, min_budget, dfa_ids, states, meta_i, meta_f,
                     eos_id: int, top_p: float):
    """Launch ``csrc/guided_sampler.cu`` on the current stream."""
    _check(logits, min_budget, dfa_ids, states, meta_i, meta_f)
    fn = _build.entry("guided_sampler", "bcg_guided_sampler", _ARGTYPES)
    B, V = logits.shape
    Vp, _ = vocab_rows(V)
    out = torch.empty((B, 2), dtype=torch.int32, device=logits.device)
    err = fn(logits.data_ptr(), min_budget.data_ptr(), dfa_ids.data_ptr(),
             states.data_ptr(), meta_i.data_ptr(), meta_f.data_ptr(), out.data_ptr(),
             B, V, Vp, min_budget.shape[1], int(eos_id), float(top_p),
             _build.stream_ptr(logits))
    _build.check(err, "guided_sampler")
    sample_rows.launches += 1
    return out[:, 0], out[:, 1] > 0


def sample_rows(logits, min_budget, dfa_ids, states, meta_i, meta_f,
                eos_id: int, top_p: float):
    """The fused sampler: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if logits.device.type == "cpu":
        return sample_rows_plain(logits, min_budget, dfa_ids, states, meta_i,
                                 meta_f, eos_id, top_p)
    return sample_rows_cuda(logits, min_budget, dfa_ids, states, meta_i,
                            meta_f, eos_id, top_p)


sample_rows.launches = 0


def make_fused_sampler(eos_id: int, top_p: float):
    """Engine-level sampler with ``make_masked_sampler``'s contract:
    ``masked_sample(logits, states, generator, emitted, tables, accepting,
    min_budget, dfa_ids, row_temp, row_budget, forbid=None, u=None)`` ->
    ``(token [B] int32, next_states [B] int32)``.  ``u`` (one uniform per
    row) is drawn from ``generator`` unless given."""

    def masked_sample(logits, states, generator, emitted, tables, accepting,
                      min_budget, dfa_ids, row_temp, row_budget,
                      forbid: Optional[torch.Tensor] = None,
                      u: Optional[torch.Tensor] = None):
        B, V = logits.shape
        dev = logits.device
        clamped = states.clamp(min=0).to(torch.int32)
        budget_left = (row_budget - emitted).to(torch.int32)
        eos_ok = accepting[dfa_ids.long(), clamped.long()]
        greedy_row = row_temp <= 0.0
        safe_temp = torch.where(greedy_row, torch.ones_like(row_temp), row_temp)
        if u is None:
            u = torch.rand((B,), generator=generator, device=dev, dtype=torch.float32)
        fb = (forbid.to(torch.int32) if forbid is not None
              else torch.full((B,), -1, dtype=torch.int32, device=dev))
        meta_i = torch.stack(
            [budget_left, fb, greedy_row.to(torch.int32), eos_ok.to(torch.int32)], dim=1
        ).contiguous()
        meta_f = torch.stack([safe_temp.float(), u.float()], dim=1).contiguous()
        tok, any_tok = sample_rows(
            logits.float().contiguous(), min_budget, dfa_ids.to(torch.int32),
            clamped, meta_i, meta_f, eos_id, top_p,
        )
        # Dead end (no token allowed): force EOS, as the XLA reference does.
        tok = torch.where(any_tok, tok, torch.full_like(tok, eos_id))
        nxt = tables[dfa_ids.long(), clamped.long(), tok.long().clamp(max=V - 1)]
        nxt = torch.where(tok == eos_id, torch.full_like(tok, -1), nxt.to(torch.int32))
        return tok, nxt

    return masked_sample
