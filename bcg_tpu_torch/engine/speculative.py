"""The plain guided sampler (port of the sampler half of
``bcg_tpu/engine/speculative.py``: ``make_masked_logits`` /
``make_masked_sampler``).

This is the conformance reference the fused sampler kernel
(:mod:`bcg_tpu_torch.ops.guided_sampler`) is held against: greedy rows
must be token-identical.  The speculative drafter and acceptance loop
are not ported yet (ROADMAP A7).
"""

from __future__ import annotations

from typing import Optional

import torch


def make_masked_logits(eos_id: int, top_p: float):
    """The filter stage: raw logits -> the masked / temperature-scaled /
    top-p-filtered log-weights the sampler draws from.

    Guaranteed parse: a token is allowed only if the state it leads to can
    still reach acceptance within the remaining budget (``min_budget``
    per (state, token), which also encodes "forbidden" by its sentinel).
    """
    use_top_p = top_p < 1.0

    def masked_logits(logits, states, emitted, tables, accepting, min_budget,
                      dfa_ids, row_temp, row_budget):
        clamped = states.clamp(min=0).long()
        d = dfa_ids.long()
        budget_left = row_budget - emitted              # [B], incl. this token
        allowed = min_budget[d, clamped] <= budget_left[:, None]
        eos_ok = accepting[d, clamped]
        any_tok = allowed.any(dim=-1)
        greedy_row = row_temp <= 0.0
        safe_temp = torch.where(greedy_row, torch.ones_like(row_temp), row_temp)[:, None]
        scaled = logits / safe_temp
        neg = torch.tensor(float("-inf"), device=logits.device)
        lg = torch.where(allowed, scaled, neg)
        # EOS is legal exactly at accepting states.
        lg[:, eos_id] = torch.where(eos_ok, scaled[:, eos_id], neg)
        if use_top_p:
            # Nucleus filter: keep the smallest prefix of the sorted
            # distribution whose mass reaches top_p.
            probs = torch.softmax(lg, dim=-1)
            sorted_probs = torch.sort(probs, dim=-1, descending=True).values
            cum = torch.cumsum(sorted_probs, dim=-1)
            cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
            cutoff_idx = cutoff_idx.clamp(max=lg.shape[-1] - 1)
            cutoff = torch.gather(sorted_probs, -1, cutoff_idx)
            lg = torch.where(probs >= cutoff, lg, neg)
        return lg, any_tok, greedy_row

    return masked_logits


def make_masked_sampler(eos_id: int, top_p: float):
    """The full plain sampler (filter + draw).  Sampled rows draw by the
    Gumbel-max trick (``jax.random.categorical``'s method) from
    ``generator``; ``forbid`` masks one token per row after the top-p
    filter.  Returns ``(token [B] int32, next_states [B] int32)``."""
    masked_logits = make_masked_logits(eos_id, top_p)

    def masked_sample(logits, states, generator, emitted, tables, accepting,
                      min_budget, dfa_ids, row_temp, row_budget,
                      forbid: Optional[torch.Tensor] = None):
        lg, any_tok, greedy_row = masked_logits(
            logits, states, emitted, tables, accepting, min_budget, dfa_ids,
            row_temp, row_budget,
        )
        if forbid is not None:
            V = lg.shape[-1]
            hit = (torch.arange(V, device=lg.device)[None, :] == forbid[:, None]) \
                & (forbid >= 0)[:, None]
            lg = torch.where(hit, torch.tensor(float("-inf"), device=lg.device), lg)
        u = torch.rand(lg.shape, generator=generator, device=lg.device)
        gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
        tok = torch.where(greedy_row, torch.argmax(lg, dim=-1),
                          torch.argmax(lg + gumbel, dim=-1))
        # Dead end (no token allowed): force EOS.
        tok = torch.where(any_tok, tok, torch.full_like(tok, eos_id))
        nxt = tables[dfa_ids.long(), states.clamp(min=0).long(), tok].to(torch.int32)
        nxt = torch.where(tok == eos_id, torch.full_like(nxt, -1), nxt)
        return tok.to(torch.int32), nxt

    return masked_sample
