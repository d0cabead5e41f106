"""Game round step: topology-masked message exchange, vote tally and
consensus check as tensor math on one device — the port of the dense
part of ``bcg_tpu/parallel/game_step.py`` (``:29-162``).

These are the bodies the fused mega-round program runs
(:func:`bcg_tpu_torch.engine.megaround.build_round_program`): "broadcast
to neighbours" is a static receiver mask over the proposal vector (or
per-receiver proposal matrix), vote counting and the consensus check
are reductions over the agent axis.  Semantics match the host game
exactly (tested against the JAX package).

The SPMD forms (``exchange_values`` through ``shard_agents``,
``:164-391``) run the same bodies over the agents' split across the
mesh's ``dp`` ranks: each rank passes its own agents' rows (the slice
:func:`shard_agents` gives it) and the collectives of
:mod:`bcg_tpu_torch.parallel.collectives` supply the rest.  Without a
mesh (or at dp = 1) they are the dense forms.

Value conventions: ``value < 0`` encodes abstention (no proposal);
votes are ints {1: stop, 0: continue, -1: abstain}.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bcg_tpu_torch.parallel.collectives import all_gather, all_reduce, axis_rank, axis_size


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


# ------------------------------------------------------------ SPMD forms


def exchange_values(
    values: torch.Tensor,         # [n/dp] int32: this rank's agents, -1 = abstain
    neighbor_mask: torch.Tensor,  # [n/dp, n] bool: this rank's receiver rows
    mesh,
    axis_name: str = "dp",
) -> torch.Tensor:
    """Neighbour-masked all-gather: every rank's values gathered, then
    this rank's receiver rows masked — row i holds agent j's value if j
    is i's neighbour AND j proposed, else -1.  Returns ``[n/dp, n]``."""
    return _masked_receive(all_gather(values, mesh, axis_name), neighbor_mask)


def exchange_proposals(
    proposals: torch.Tensor,     # [n, n/dp] int32: this rank's sender columns
    receiver_mask: torch.Tensor,  # [n/dp, n] bool: this rank's receiver rows
    mesh,
    axis_name: str = "dp",
) -> torch.Tensor:
    """Per-receiver (equivocation-capable) form of
    :func:`exchange_values`: each rank owns its senders' COLUMNS of
    per-receiver values; the columns are gathered and this rank's
    receiver rows masked.  Returns ``[n/dp, n]``."""
    full = all_gather(proposals, mesh, axis_name, dim=1)
    rows = receiver_mask.shape[0]
    local = full.narrow(0, axis_rank(mesh, axis_name) * rows, rows)
    return _masked_receive_matrix(local, receiver_mask)


def tally_votes(votes: torch.Tensor, mesh, axis_name: str = "dp") -> Dict[str, torch.Tensor]:
    """:func:`tally_votes_dense` of every rank's votes (``[n/dp]`` here):
    the three counts summed over ``dp``."""
    counts = torch.stack([(votes == 1).sum(), (votes == 0).sum(), (votes == -1).sum()])
    stop, cont, abstain = all_reduce(counts, mesh, axis_name)
    total = stop + cont + abstain
    return {
        "stop": stop,
        "continue": cont,
        "abstain": abstain,
        "terminate": stop * 3 >= total * 2,
        "half_stop": stop * 2 >= total,
    }


def check_consensus_spmd(
    values: torch.Tensor,          # [n/dp] int32
    is_byzantine: torch.Tensor,    # [n/dp] bool
    initial_values: torch.Tensor,  # [n/dp] int32
    mesh,
    axis_name: str = "dp",
) -> Dict[str, torch.Tensor]:
    """:func:`check_consensus_dense` over every rank's agents (gathered)."""
    gathered = [all_gather(t, mesh, axis_name) for t in (values, is_byzantine, initial_values)]
    return check_consensus_dense(*gathered)


def spmd_round_arrays(
    proposals: torch.Tensor,      # [n/dp] int32, -1 abstain
    votes: torch.Tensor,          # [n/dp] int32 {1, 0, -1}
    neighbor_mask: torch.Tensor,  # [n/dp, n] bool
    is_byzantine: torch.Tensor,
    initial_values: torch.Tensor,
    mesh,
    axis_name: str = "dp",
) -> Tuple[torch.Tensor, Dict, Dict]:
    """One post-decision round: exchange, tally and consensus check."""
    received = exchange_values(proposals, neighbor_mask, mesh, axis_name)
    tally = tally_votes(votes, mesh, axis_name)
    consensus = check_consensus_spmd(proposals, is_byzantine, initial_values, mesh, axis_name)
    return received, tally, consensus


def shard_agents(n_agents: int, mesh, axis_name: str = "dp") -> slice:
    """This rank's agents: an equal slice of ``n_agents`` along
    ``axis_name`` (the indivisible case raises)."""
    d = axis_size(mesh, axis_name)
    if n_agents % d:
        raise ValueError(f"{n_agents} agents not divisible by {axis_name}={d}")
    per = n_agents // d
    r = axis_rank(mesh, axis_name)
    return slice(r * per, (r + 1) * per)
