"""Fused guided sampler: the kernel's wrapper and its plain version.

Port of ``bcg_tpu/ops/guided_sampler.py``.  Every decode step runs the
guided sampler over the whole ``[B, V]`` logits: the DFA allowed-mask
(a ``min_budget[dfa, state]`` row), the EOS gate, temperature, the
top-p cutoff by bisection of the kept mass, and the greedy argmax or the
inverse-CDF draw — one thread-block cluster per row in
``csrc/guided_sampler.cu``, laid out by :func:`sampler_plan`.

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
import functools
from collections import namedtuple
from typing import Callable, Optional

import torch

from bcg_tpu_torch.obs import compile as obs_compile
from bcg_tpu_torch.ops import _build

_NEG_INF = -1e30
_LANES = 128
# Bisection iteration counts and the top-p log-prob range — the TPU
# kernel's constants (fp32-exact threshold at 30; ceil(log2 V) <= 21).
_TOPP_ITERS = 30
_CDF_ITERS = 21
_TOPP_RANGE = 30.0
_P, _I = ctypes.c_void_p, ctypes.c_int
# logits, min_budget, dfa_ids, states, meta_i, meta_f, token, any_tok,
# dims (int[9], see _launch_dims), top_p, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_float, _P]
# c, smem, out (int*)
_MAX_CLUSTERS_ARGTYPES = [_I, _I, _P]

# The kernel's launch geometry (``csrc/guided_sampler.cu``): threads a CTA,
# the top-p tree's thread-private bins, cluster sizes it may take (largest
# first; above 8 only where the occupancy query admits them), the fewest
# tokens a CTA of a cluster of more than one takes, the most tokens a
# thread's bit masks cover, and the dynamic shared memory a CTA may ask
# for: the block's 227 KB less 8 KB for the kernel's static arrays (the
# cluster's mailboxes, the barriers, each warp's tree).
SAMPLER_THREADS = 512
SAMPLER_BINS = 32
CLUSTER_SIZES = (16, 8, 4, 2, 1)
MIN_SLICE = 4096
MAX_CHUNK = 96
SMEM_LIMIT = 232448 - 8192

SamplerPlan = namedtuple("SamplerPlan", "c slice chunk smem_bytes one_wave")


def _chunk(slice_len: int) -> int:
    """Tokens a thread owns contiguously: at least its share of the slice,
    4 mod 8 so that a quarter warp's 16-byte reads of eight chunks hit
    distinct shared-memory banks."""
    ch = max(1, -(-slice_len // SAMPLER_THREADS))
    return ch + (4 - ch) % 8


def sampler_plan(B: int, V: int, top_p: float, sms: int = 132,
                 max_clusters: Optional[Callable[[int, int], int]] = None) -> SamplerPlan:
    """The kernel's launch plan for ``B`` rows of ``V`` tokens: ``c`` CTAs
    a row, CTA r owning tokens ``[r * slice, min((r + 1) * slice, V))``
    (``slice`` a multiple of 8), each thread ``chunk`` of them, and the
    dynamic shared memory: x for ``SAMPLER_THREADS * chunk`` tokens, then
    the slice's int16 budgets as they land, a space the top-p bins reuse
    when ``top_p < 1``.  The largest ``c`` whose ``B * c``
    CTAs fit ``sms`` SMs and whose ``B`` clusters the card holds at once
    (``max_clusters(c, smem)``, the occupancy query; ``sms // c`` when not
    given), so that the rows run in one wave; where none does, the smallest
    ``c`` whose slice fits shared memory (``one_wave``: the card holds all
    ``B`` clusters at once).  Raises if no ``c`` fits."""
    topp = top_p < 1.0
    fits = []
    for c in CLUSTER_SIZES:
        per = -(-V // c)
        if c > 1 and per < MIN_SLICE:
            continue
        sl = -(-per // 8) * 8
        ch = _chunk(sl)
        smem = 4 * SAMPLER_THREADS * ch + max(2 * sl, 4 * SAMPLER_BINS * SAMPLER_THREADS * topp)
        if smem > SMEM_LIMIT or ch > MAX_CHUNK:
            continue
        held = max_clusters(c, smem) if max_clusters is not None else sms // c
        if held >= 1:
            fits.append((c, sl, ch, smem, held))
    if not fits:
        raise ValueError(f"guided_sampler: no cluster plan fits {V} tokens a row "
                         f"(top_p {top_p}) in {SMEM_LIMIT} bytes of shared memory a CTA")
    c, sl, ch, smem, held = next((f for f in fits if B * f[0] <= sms and f[4] >= B), fits[-1])
    return SamplerPlan(c, sl, ch, smem, held >= B)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, c: int, smem: int) -> int:
    fn = _build.entry("guided_sampler", "bcg_guided_sampler_max_clusters",
                      _MAX_CLUSTERS_ARGTYPES)
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        _build.check(fn(c, smem, ctypes.addressof(n)), "guided_sampler occupancy query")
    return n.value


@functools.lru_cache(maxsize=None)
def _cuda_plan(index: int, B: int, V: int, top_p: float) -> SamplerPlan:
    return sampler_plan(B, V, top_p, _sms(index), lambda c, smem: _max_clusters(index, c, smem))


def cuda_plan(device, B: int, V: int, top_p: float) -> SamplerPlan:
    """:func:`sampler_plan` on CUDA ``device``, with its SM count and the
    kernel's occupancy query (both cached, so a launch inside a graph
    capture asks nothing of the runtime once a call of the same shape ran
    before it)."""
    index = torch.device(device).index
    return _cuda_plan(torch.cuda.current_device() if index is None else index, B, V,
                      float(top_p))


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
    f32, i32, dev = torch.float32, torch.int32, logits.get_device()
    for t, dt, shape in ((logits, f32, (B, V)), (dfa_ids, i32, (B,)), (states, i32, (B,)),
                         (meta_i, i32, (B, 4)), (meta_f, f32, (B, 2))):
        if t.dtype != dt or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"guided_sampler kernel takes contiguous {dt} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.get_device() != dev:
            raise ValueError("guided_sampler: tensors on different devices")
    if min_budget.dtype != torch.int16 or min_budget.dim() != 3 \
            or min_budget.shape[2] != V or not min_budget.is_contiguous():
        raise ValueError(f"guided_sampler kernel takes a contiguous int16 min_budget "
                         f"[n_dfa, n_states, {V}], got {min_budget.dtype} "
                         f"{tuple(min_budget.shape)}")
    if min_budget.get_device() != dev:
        raise ValueError("guided_sampler: tensors on different devices")


# The kernel's scalars for each call shape, packed once:
# [B, V, Vp, n_states, eos_id, c, slice, chunk, smem_bytes].
_dims = {}


def _launch_dims(index: int, B: int, V: int, n_states: int, eos_id: int, top_p: float):
    key = (index, B, V, n_states, eos_id, top_p)
    dims = _dims.get(key)
    if dims is None:
        # A new call shape: its plan (the occupancy query, on a plan
        # cache miss) is the first call's one-time cost.
        with obs_compile.time_block("sampler_plan"):
            plan = _cuda_plan(index, B, V, top_p)
        obs_compile.note_shape("sampler_plan", (B, V, top_p),
                               names=("batch", "vocab", "top_p"), timing="stash")
        dims = _dims[key] = (ctypes.c_int * 9)(
            B, V, vocab_rows(V)[0], n_states, eos_id, plan.c, plan.slice, plan.chunk,
            plan.smem_bytes)
    return ctypes.addressof(dims)


def sample_rows_cuda(logits, min_budget, dfa_ids, states, meta_i, meta_f,
                     eos_id: int, top_p: float):
    """Launch ``csrc/guided_sampler.cu`` on the current stream: one
    cluster launch at :func:`cuda_plan`'s plan (raises if there is none or
    the runtime refuses the launch)."""
    _check(logits, min_budget, dfa_ids, states, meta_i, meta_f)
    fn = _build.entry("guided_sampler", "bcg_guided_sampler", _ARGTYPES)
    B, V = logits.shape
    index = logits.get_device()
    dims = _launch_dims(index, B, V, min_budget.shape[1], int(eos_id), float(top_p))
    tok = torch.empty((B,), dtype=torch.int32, device=logits.device)
    any_tok = torch.empty((B,), dtype=torch.bool, device=logits.device)
    err = fn(logits.data_ptr(), min_budget.data_ptr(), dfa_ids.data_ptr(),
             states.data_ptr(), meta_i.data_ptr(), meta_f.data_ptr(), tok.data_ptr(),
             any_tok.data_ptr(), dims, float(top_p), _build.stream_ptr(logits))
    _build.check(err, "guided_sampler")
    sample_rows.launches += 1
    return tok, any_tok


def sample_rows(logits, min_budget, dfa_ids, states, meta_i, meta_f,
                eos_id: int, top_p: float):
    """The fused sampler: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    sample_rows.calls += 1
    if logits.device.type == "cpu":
        return sample_rows_plain(logits, min_budget, dfa_ids, states, meta_i,
                                 meta_f, eos_id, top_p)
    return sample_rows_cuda(logits, min_budget, dfa_ids, states, meta_i,
                            meta_f, eos_id, top_p)


sample_rows.launches = 0
sample_rows.calls = 0


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
