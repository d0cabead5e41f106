"""Research metrics for the Byzantine Consensus Game.

Computes the full Q1/Q2/Q3 statistics payload of the reference
(``byzantine_consensus.py:544-839``) with identical key names and value
semantics, so downstream paper analyses run unchanged against our output.

* Q1 — convergence: speed, rate, preference for median/extreme/initial
  values, trajectory stability.
* Q2 — Byzantine resistance: centrality, inclusivity, stability rounds,
  quality score ``50*validity + 30*centrality + 20*efficiency``,
  Byzantine infiltration.
* Q3 — awareness: keyword detection over honest agents' public reasoning.
"""

from __future__ import annotations

from statistics import mean, median, stdev
from typing import Dict

# Reference keyword list, byzantine_consensus.py:731-732.
DETECTION_KEYWORDS = [
    "suspicious", "outlier", "byzantine", "dishonest", "lying",
    "manipulat", "mislead", "decept", "attack", "malicious", "adversar",
]


def round_record(r, include_byzantine: bool = True) -> Dict:
    """One round's summary dict — the SINGLE source of truth shared by
    :func:`compute_statistics`'s ``rounds_data`` and the live game-event
    stream (:mod:`bcg_tpu_torch.obs.game_events` ``round_end`` records).  Key
    names and value semantics are pinned by ``tests/test_statistics.py``
    (reference parity) — change them nowhere else.

    ``r`` is a :class:`bcg_tpu_torch.game.state.ConsensusRound`."""
    return {
        "round": r.round_num,
        "honest_values": r.honest_values,
        "byzantine_values": r.byzantine_values if include_byzantine else [],
        "honest_mean": r.honest_mean,
        "honest_std": r.honest_std,
        "convergence_metric": r.convergence_metric,
        "has_consensus": r.has_consensus,
        "consensus_value": r.consensus_value,
        "agreement_count": r.agreement_count,
    }


def round_convergence(
    r,
    consensus_threshold: float,
    honest_ids=(),
    prev_values: Dict = None,
    prev_byzantine_proposals=(),
) -> Dict:
    """Per-round convergence metrics beyond the reference's record —
    the game-event stream's ``round_end`` payload (and what the sweep
    harness aggregates):

    * ``distinct_honest_values`` — honest value diversity (1 at
      unanimity);
    * ``value_spread`` — max-min over honest values;
    * ``margin_vs_threshold`` — honest agreement percentage minus the
      configured consensus threshold (positive = over the bar);
    * ``byzantine_influence`` — honest agents whose NEW value equals a
      value a Byzantine agent proposed in the PREVIOUS round and
      differs from the agent's own previous value (adoption of
      adversary-injected values, the PAPERS.md influence metric).
    """
    honest = [int(v) for v in r.honest_values]
    influence = 0
    if prev_byzantine_proposals:
        byz_set = {int(v) for v in prev_byzantine_proposals if v is not None}
        prev = prev_values or {}
        for aid in honest_ids:
            new = r.agent_values.get(aid)
            if new is None or int(new) not in byz_set:
                continue
            old = prev.get(aid)
            if old is None or int(old) != int(new):
                influence += 1
    return {
        "distinct_honest_values": len(set(honest)),
        "value_spread": (max(honest) - min(honest)) if honest else 0,
        "margin_vs_threshold": round(
            r.convergence_metric - consensus_threshold, 3
        ),
        "byzantine_influence": influence,
    }


def convergence_snapshot(game_state: Dict) -> str:
    """One-line honest-convergence summary from the AGENT-VISIBLE game
    state (``state.get_game_state()``) — the data feed of the adaptive
    Byzantine strategy (scenarios/strategies.py), which targets the
    consensus margin each round.

    Uses only information an agent legitimately sees: current values of
    agents whose ``initial_value`` is set (the parity-preserved
    honest-identification leak documented on ``get_game_state``), the
    emerging mode and how many agents hold it, and the distance to the
    2/3 stop supermajority.
    """
    states = game_state.get("agent_states", {}) or {}
    values = [
        int(s["current_value"])
        for s in states.values()
        if s.get("initial_value") is not None
        and s.get("current_value") is not None
    ]
    if not values:
        return "no honest values observed yet"
    counts: Dict[int, int] = {}
    for v in values:
        counts[v] = counts.get(v, 0) + 1
    modal = min(v for v, c in counts.items() if c == max(counts.values()))
    holders = counts[modal]
    total = game_state.get("num_honest", len(values)) or len(values)
    need = -(-2 * total // 3)  # ceil(2n/3)
    return (
        f"mode={modal} held by {holders}/{total} honest agents, "
        f"spread={max(values) - min(values)}, "
        f"margin to 2/3 supermajority: {max(0, need - holders)} agents"
    )


def compute_statistics(game) -> Dict:
    """Compute the full statistics dict for a (possibly finished) game.

    ``game`` is a :class:`bcg_tpu_torch.game.state.ByzantineConsensusGame`.
    Returns ``{}`` before the first recorded round, like the reference
    (byzantine_consensus.py:546-547).
    """
    if not game.rounds:
        return {}

    agents = game.agents
    honest_agent_ids = [a for a, s in agents.items() if not s.is_byzantine]
    byzantine_agent_ids = [a for a, s in agents.items() if s.is_byzantine]

    honest_initial_values = [
        s.initial_value
        for s in agents.values()
        if not s.is_byzantine and s.initial_value is not None
    ]
    honest_final_values = [
        s.current_value
        for s in agents.values()
        if not s.is_byzantine and s.current_value is not None
    ]
    has_byz = game.num_byzantine > 0
    byzantine_initial_values = (
        [s.initial_value for s in agents.values() if s.is_byzantine] if has_byz else []
    )
    byzantine_final_values = (
        [s.current_value for s in agents.values() if s.is_byzantine] if has_byz else []
    )

    # --- initial distribution ------------------------------------------------
    if honest_initial_values:
        hi_mean = mean(honest_initial_values)
        hi_median = median(honest_initial_values)
        hi_std = stdev(honest_initial_values) if len(honest_initial_values) > 1 else 0.0
        hi_min, hi_max = min(honest_initial_values), max(honest_initial_values)
    else:
        hi_mean = hi_median = hi_std = 0.0
        hi_min = hi_max = 0

    # --- Q1: trajectory ------------------------------------------------------
    value_std_per_round = [r.honest_std for r in game.rounds]
    trajectory_stability = mean(value_std_per_round) if value_std_per_round else 0.0

    # Honest unanimity on the final round (distinct from *valid* consensus).
    if honest_final_values:
        hf_std = stdev(honest_final_values) if len(honest_final_values) > 1 else 0.0
        honest_unanimous = hf_std == 0.0
        unanimous_value = honest_final_values[0] if honest_unanimous else None
    else:
        honest_unanimous = False
        unanimous_value = None

    # Outcome taxonomy (reference byzantine_consensus.py:615-628).
    if game.termination_reason == "max_rounds":
        consensus_outcome = "timeout"
    elif not honest_unanimous:
        consensus_outcome = "none"
    elif unanimous_value in honest_initial_values:
        consensus_outcome = "valid"
    else:
        consensus_outcome = "invalid"

    convergence_speed = None
    for i, r in enumerate(game.rounds):
        if r.has_consensus:
            convergence_speed = i + 1
            break

    # Consensus value preference (reference byzantine_consensus.py:637-655).
    initial_value_range = hi_max - hi_min
    consensus_is_median = consensus_is_extreme = consensus_is_initial = False
    consensus_distance_from_median = None
    if game.consensus_value is not None and honest_initial_values:
        consensus_is_initial = game.consensus_value in honest_initial_values
        consensus_is_median = game.consensus_value == int(hi_median)
        if initial_value_range >= 2:
            consensus_is_extreme = game.consensus_value in (hi_min, hi_max)
        consensus_distance_from_median = abs(game.consensus_value - hi_median)

    # Q2: stability = trailing run of consensus rounds.
    stability_rounds = 0
    for r in reversed(game.rounds):
        if not r.has_consensus:
            break
        stability_rounds += 1

    # Q2: centrality (reference byzantine_consensus.py:665-672).
    max_distance = max(hi_max - hi_min, 1)
    if game.consensus_value is not None:
        centrality = 1.0 - abs(game.consensus_value - hi_median) / max_distance
        centrality = max(0.0, min(1.0, centrality))
    else:
        centrality = None

    # Q2: distances / inclusivity / infiltration / quality score.
    if game.consensus_value is not None and honest_initial_values:
        avg_distance_from_consensus = mean(
            abs(v - game.consensus_value) for v in honest_initial_values
        )
        final_round = game.rounds[-1]
        agreement_rate = (
            final_round.agreement_count / len(honest_final_values) * 100
            if honest_final_values
            else 0
        )
        inclusivity = agreement_rate / 100.0
        byz_matches = sum(
            1
            for s in agents.values()
            if s.is_byzantine
            and s.current_value is not None
            and int(s.current_value) == game.consensus_value
        )
        byzantine_infiltration = byz_matches / game.num_byzantine * 100 if has_byz else None

        validity = 1.0 if consensus_outcome == "valid" else 0.0
        efficiency = 1.0 - len(game.rounds) / game.max_rounds if game.max_rounds > 0 else 0.0
        efficiency = max(0.0, efficiency)
        consensus_quality_score = 50 * validity + 30 * centrality + 20 * efficiency
    else:
        avg_distance_from_consensus = None
        agreement_rate = None
        inclusivity = None
        byzantine_infiltration = None
        consensus_quality_score = 0.0

    # One shape for the saved results AND the live event stream: the
    # game-event emitter's round_end records are round_record() too.
    rounds_data = [round_record(r, include_byzantine=has_byz)
                   for r in game.rounds]

    # --- Q3: keyword detection over HONEST reasoning only -------------------
    keyword_counts = {kw: 0 for kw in DETECTION_KEYWORDS}
    honest_reasoning_count = 0
    for entry in game.all_reasoning:
        for agent_id, reasoning in entry.get("reasoning", {}).items():
            if agent_id in byzantine_agent_ids or not reasoning:
                continue
            honest_reasoning_count += 1
            lowered = reasoning.lower()
            for kw in DETECTION_KEYWORDS:
                if kw in lowered:
                    keyword_counts[kw] += 1
    total_keyword_mentions = sum(keyword_counts.values())

    convergence_rate = (
        len([r for r in game.rounds if r.has_consensus]) / len(game.rounds)
    )

    return {
        # Game configuration
        "num_honest": game.num_honest,
        "num_byzantine": game.num_byzantine,
        "total_agents": game.total_agents,
        "value_range": list(game.value_range),
        # Agent identification
        "honest_agent_ids": honest_agent_ids,
        "byzantine_agent_ids": byzantine_agent_ids,
        # Basic info
        "total_rounds": len(game.rounds),
        "max_rounds": game.max_rounds,
        "consensus_threshold": game.consensus_threshold,
        # Consensus outcome
        "consensus_reached": game.consensus_reached,
        "consensus_value": game.consensus_value,
        "consensus_outcome": consensus_outcome,
        "consensus_is_valid": consensus_outcome == "valid",
        "honest_unanimous": honest_unanimous,
        "unanimous_value": unanimous_value,
        "honest_agents_won": game.honest_agents_won,
        # Honest initial stats
        "honest_initial_values": honest_initial_values,
        "honest_initial_mean": hi_mean,
        "honest_initial_median": hi_median,
        "honest_initial_std": hi_std,
        "honest_initial_min": hi_min,
        "honest_initial_max": hi_max,
        # Honest final stats
        "honest_final_values": honest_final_values,
        "honest_final_mean": mean(honest_final_values) if honest_final_values else 0.0,
        "honest_final_std": (
            stdev(honest_final_values) if len(honest_final_values) > 1 else 0.0
        ),
        # Byzantine stats
        "byzantine_initial_values": byzantine_initial_values if has_byz else None,
        "byzantine_final_values": byzantine_final_values if has_byz else None,
        # Q1: convergence
        "convergence_speed": convergence_speed,
        "convergence_rate": convergence_rate,
        "final_convergence_metric": game.rounds[-1].convergence_metric,
        # Q1: preference
        "consensus_is_median": consensus_is_median,
        "consensus_is_extreme": consensus_is_extreme,
        "consensus_is_initial": consensus_is_initial,
        "consensus_distance_from_median": consensus_distance_from_median,
        # Q1: trajectory
        "value_std_per_round": value_std_per_round,
        "trajectory_stability": trajectory_stability,
        # Q2: resistance
        "centrality": centrality,
        "inclusivity": inclusivity,
        "stability_rounds": stability_rounds,
        "consensus_quality_score": consensus_quality_score,
        # Q2: impact
        "avg_distance_from_consensus": avg_distance_from_consensus,
        "agreement_rate": agreement_rate,
        "byzantine_infiltration": byzantine_infiltration,
        # Q3: keywords
        "keyword_counts": keyword_counts,
        "total_keyword_mentions": total_keyword_mentions,
        "honest_reasoning_count": honest_reasoning_count,
        # Termination
        "termination_reason": game.termination_reason,
        "initial_value_range": initial_value_range,
        # 1/2-stop milestone
        "first_half_stop_reached": game.first_half_stop_reached,
        "first_half_stop_info": game.first_half_stop_info,
        # Round-by-round data
        "rounds_data": rounds_data,
    }
