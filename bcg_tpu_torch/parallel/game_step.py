"""Game round step: topology-masked message exchange, vote tally and
consensus check as tensor math on one device — the port of the dense
part of ``bcg_tpu/parallel/game_step.py`` (``:29-162``).

These are the bodies the fused mega-round program runs
(:func:`bcg_tpu_torch.engine.megaround.build_round_program`): "broadcast
to neighbours" is a static receiver mask over the proposal vector (or
per-receiver proposal matrix), vote counting and the consensus check
are reductions over the agent axis.  Semantics match the host game
exactly (tested against the JAX package).  The SPMD forms over a mesh
(``exchange_values`` through ``shard_agents``, ``:164-391``) are ROADMAP
A13 and are not here.

Value conventions: ``value < 0`` encodes abstention (no proposal);
votes are ints {1: stop, 0: continue, -1: abstain}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _masked_receive(all_vals: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """The exchange body shared by every delivery path: row i of the
    result holds agent j's value iff ``mask_rows[i, j]`` AND j proposed
    (``all_vals[j] >= 0``), else -1."""
    return torch.where(mask_rows & (all_vals >= 0)[None, :], all_vals[None, :],
                       torch.full_like(all_vals[None, :], -1))


def masked_exchange(
    values: torch.Tensor,         # [n] int32, -1 = abstain
    receiver_mask: torch.Tensor,  # [n, n] bool, mask[i, j] = i receives from j
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense topology-masked exchange.  Returns ``(received,
    deliveries)`` where ``received[i, j]`` is agent j's value as seen by
    agent i (-1 = not delivered) and ``deliveries[i]`` is the number of
    proposals delivered to receiver i — the adjacency mask applied as a
    masked matmul over the proposed-indicator vector, which is also the
    per-receiver count the orchestrator's ``deliveries`` game event and
    message accounting read."""
    received = _masked_receive(values, receiver_mask)
    proposed = (values >= 0).to(torch.int32)
    deliveries = (receiver_mask.to(torch.int32) * proposed[None, :]).sum(dim=1, dtype=torch.int32)
    return received, deliveries


def _masked_receive_matrix(proposals: torch.Tensor, mask_rows: torch.Tensor) -> torch.Tensor:
    """Per-receiver generalization of :func:`_masked_receive`:
    ``proposals[i, j]`` is the value sender j addressed TO receiver i
    (equivocating senders put different values in different rows; a
    broadcasting sender's column is constant).  Row i of the result
    holds that value iff ``mask_rows[i, j]`` AND the sender proposed
    (``proposals[i, j] >= 0``), else -1."""
    return torch.where(mask_rows & (proposals >= 0), proposals, torch.full_like(proposals, -1))


def masked_exchange_matrix(
    proposals: torch.Tensor,      # [n, n] int32, [i, j] = j's value for i
    receiver_mask: torch.Tensor,  # [n, n] bool, mask[i, j] = i receives from j
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-receiver form of :func:`masked_exchange`: an elementwise mask
    over a proposal MATRIX, which is what equivocating adversaries need
    (one sender, different values to different receivers).  When every
    column of ``proposals`` is constant (nobody equivocates) this equals
    ``masked_exchange(proposals[0], mask)``, so the fused round routes
    ALL rounds through it without changing the non-equivocating
    semantics."""
    received = _masked_receive_matrix(proposals, receiver_mask)
    delivered = receiver_mask & (proposals >= 0)
    deliveries = delivered.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return received, deliveries


def equivocate_proposals(
    values: torch.Tensor,        # [n] int32 base proposals, -1 = abstain
    equivocators: torch.Tensor,  # [n] bool, True = sender equivocates
    lo: int,
    hi: int,
) -> torch.Tensor:
    """Expand base proposals to the per-receiver proposal matrix:
    column j is constant (the broadcast value) for honest/non-
    equivocating senders, and the deterministic per-receiver spread
    :func:`bcg_tpu_torch.scenarios.strategies.equivocation_value` for
    equivocating senders that proposed.  Abstaining senders stay -1
    for every receiver.  The all-False case is exactly the broadcast,
    preserving the fused round's greedy identity to the lockstep
    oracle."""
    from bcg_tpu_torch.scenarios.strategies import equivocation_value

    n = values.shape[0]
    broadcast = values[None, :].expand(n, n)
    receiver_idx = torch.arange(n, dtype=values.dtype, device=values.device)[:, None]
    spread = equivocation_value(values[None, :], receiver_idx, lo, hi).to(values.dtype)
    return torch.where(equivocators[None, :] & (values >= 0)[None, :], spread, broadcast)


def tally_votes_dense(votes: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Vote tally (the 2n/3 rule of the reference's
    byzantine_consensus.py:373-398): scalar tensors, no host read."""
    stop = (votes == 1).sum()
    cont = (votes == 0).sum()
    abstain = (votes == -1).sum()
    total = stop + cont + abstain
    return {
        "stop": stop,
        "continue": cont,
        "abstain": abstain,
        "terminate": stop * 3 >= total * 2,
        "half_stop": stop * 2 >= total,
    }


def check_consensus_dense(
    values: torch.Tensor,          # [n] int32 current values, -1 = none
    is_byzantine: torch.Tensor,    # [n] bool
    initial_values: torch.Tensor,  # [n] int32 honest initials, -1 for Byz
) -> Dict[str, torch.Tensor]:
    """The reference's exact consensus rule (byzantine_consensus.py:
    182-249): ALL honest agents hold the same value AND it is some
    honest agent's initial value.  Scalar tensors: ``has_consensus``,
    ``consensus_value`` (the modal honest value) and ``agreement_pct``
    (f32, the modal count over the honest agents holding a value).
    Ties in the modal count go to the lowest agent index."""
    honest_valid = (~is_byzantine) & (values >= 0)
    n_honest = honest_valid.sum()
    same = honest_valid[:, None] & honest_valid[None, :] & (
        values[:, None] == values[None, :]
    )
    counts = torch.where(honest_valid, same.sum(dim=1), torch.zeros_like(n_honest))
    # index_select, not values[modal_idx]: a 0-dim index would be read on
    # the host (a sync inside the fused round).
    modal_idx = counts.argmax().view(1)
    ref = values.index_select(0, modal_idx)[0]
    modal_count = counts.index_select(0, modal_idx)[0]
    agreement = torch.where(
        n_honest > 0,
        modal_count.to(torch.float32) / n_honest.clamp(min=1).to(torch.float32) * 100.0,
        torch.zeros((), dtype=torch.float32, device=values.device),
    )
    all_equal = (modal_count == n_honest) & (n_honest > 0)
    from_initial = (
        (initial_values == ref) & ~is_byzantine & (initial_values >= 0)
    ).any()
    return {
        "has_consensus": all_equal & from_initial,
        "consensus_value": ref,
        "agreement_pct": agreement,
    }
