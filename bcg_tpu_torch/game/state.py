"""Byzantine Consensus Game state machine.

Semantics cloned from the reference ``byzantine_consensus.py`` (cited per
method below): honest agents hold integer values and win iff they all end on
the same *honest initial* value AND a 2/3 supermajority of ALL agents votes
to stop before the round deadline; hitting the deadline always loses.

Differences from the reference (deliberate fixes, no behaviour change when
unseeded):

* RNG is an injectable ``random.Random`` so runs are reproducible
  (the reference uses the unseeded module RNG, byzantine_consensus.py:125,138).
* Statistics live in :mod:`bcg_tpu_torch.game.statistics`.
* Full state snapshot/restore for per-round checkpointing (absent upstream).
"""

from __future__ import annotations

import random
from collections import Counter
from dataclasses import dataclass, field
from statistics import mean, median, stdev
from typing import Dict, List, Optional, Tuple


@dataclass
class AgentState:
    """Game-side per-agent record (reference byzantine_consensus.py:20-36)."""

    agent_id: str
    is_byzantine: bool
    initial_value: Optional[int]  # None for Byzantine agents
    current_value: Optional[int]
    proposed_value: Optional[int]
    value_history: List[int] = field(default_factory=list)
    proposals_received: List[Tuple[str, int]] = field(default_factory=list)

    def update_value(self, new_value: Optional[int]) -> None:
        """Promote the proposed value to current, archiving the old one."""
        if self.current_value is not None:
            self.value_history.append(self.current_value)
        self.current_value = new_value
        self.proposed_value = new_value

    def snapshot(self) -> Dict:
        return {
            "agent_id": self.agent_id,
            "is_byzantine": self.is_byzantine,
            "initial_value": self.initial_value,
            "current_value": self.current_value,
            "proposed_value": self.proposed_value,
            "value_history": list(self.value_history),
            "proposals_received": [list(p) for p in self.proposals_received],
        }

    @classmethod
    def from_snapshot(cls, data: Dict) -> "AgentState":
        return cls(
            agent_id=data["agent_id"],
            is_byzantine=data["is_byzantine"],
            initial_value=data["initial_value"],
            current_value=data["current_value"],
            proposed_value=data["proposed_value"],
            value_history=list(data.get("value_history", [])),
            proposals_received=[tuple(p) for p in data.get("proposals_received", [])],
        )


@dataclass
class ConsensusRound:
    """Recorded outcome of one round (reference byzantine_consensus.py:39-54)."""

    round_num: int
    agent_values: Dict[str, Optional[int]]
    honest_values: List[int]
    byzantine_values: List[int]
    honest_mean: float
    honest_median: float
    honest_std: float
    all_mean: float
    all_std: float
    convergence_metric: float  # honest agreement percentage, 0-100
    has_consensus: bool
    consensus_value: Optional[int] = None  # mode of honest values
    agreement_count: Optional[int] = None  # how many honest agents hold it

    def snapshot(self) -> Dict:
        data = dict(self.__dict__)
        data["agent_values"] = dict(self.agent_values)
        data["honest_values"] = list(self.honest_values)
        data["byzantine_values"] = list(self.byzantine_values)
        return data

    @classmethod
    def from_snapshot(cls, data: Dict) -> "ConsensusRound":
        return cls(**data)


class ByzantineConsensusGame:
    """Round-based consensus game with hidden Byzantine agents.

    Reference: ``byzantine_consensus.py:57-543``.
    """

    def __init__(
        self,
        num_honest: int = 8,
        num_byzantine: int = 0,
        value_range: Tuple[int, int] = (0, 50),
        consensus_threshold: float = 66.0,
        max_rounds: int = 50,
        rng: Optional[random.Random] = None,
        seed: Optional[int] = None,
    ):
        self.num_honest = num_honest
        self.num_byzantine = num_byzantine
        self.total_agents = num_honest + num_byzantine
        self.value_range = tuple(value_range)
        # Note: the reference stores/reports this threshold but hardcodes the
        # actual rules (unanimity for consensus, 2/3 for the stop vote); we
        # keep that exact behaviour (byzantine_consensus.py:228-229,391-393).
        self.consensus_threshold = consensus_threshold
        self.max_rounds = max_rounds
        self.rng = rng if rng is not None else random.Random(seed)

        self.agents: Dict[str, AgentState] = {}
        self.rounds: List[ConsensusRound] = []
        self.current_round = 1
        self.game_over = False
        self.consensus_reached = False
        self.consensus_value: Optional[int] = None
        self.honest_agents_won: Optional[bool] = None
        # vote_with_consensus | vote_without_consensus | max_rounds
        self.termination_reason: Optional[str] = None

        self.first_half_stop_reached = False
        self.first_half_stop_info: Optional[Dict] = None

        # Q3: per-round {agent_id: reasoning} for keyword analysis.
        self.all_reasoning: List[Dict] = []

        self._initialize_agents()

    # ------------------------------------------------------------------ init

    def _initialize_agents(self) -> None:
        """Create agents with hidden random Byzantine assignment.

        Reference: byzantine_consensus.py:118-147.  Honest agents draw a
        uniform integer initial value; Byzantine agents start with None and
        pick their first value via the LLM.
        """
        lo, hi = self.value_range
        order = list(range(self.total_agents))
        self.rng.shuffle(order)
        byzantine_ids = set(order[: self.num_byzantine])

        for i in range(self.total_agents):
            is_byz = i in byzantine_ids
            init = None if is_byz else self.rng.randint(lo, hi)
            self.agents[f"agent_{i}"] = AgentState(
                agent_id=f"agent_{i}",
                is_byzantine=is_byz,
                initial_value=init,
                current_value=init,
                proposed_value=init,
            )

    # ------------------------------------------------------------- accessors

    def get_agent_state(self, agent_id: str) -> AgentState:
        return self.agents[agent_id]

    def get_all_proposals(self) -> Dict[str, Optional[int]]:
        return {aid: a.proposed_value for aid, a in self.agents.items()}

    def update_agent_proposal(self, agent_id: str, new_value: int) -> None:
        self.agents[agent_id].proposed_value = int(new_value)

    def apply_proposals(self) -> None:
        for agent in self.agents.values():
            agent.update_value(agent.proposed_value)

    def store_round_reasoning(self, reasoning: Dict[str, str]) -> None:
        """Record this round's public reasoning for Q3 keyword analysis
        (reference byzantine_consensus.py:169-180)."""
        self.all_reasoning.append({"round": self.current_round, "reasoning": reasoning})

    # ------------------------------------------------------------- consensus

    def check_consensus(self) -> Tuple[bool, float]:
        """Valid consensus = ALL honest agents hold the same value AND that
        value is one of the honest agents' initial values.

        Reference: byzantine_consensus.py:182-249, including the 0-value and
        1-value edge cases.
        """
        honest_values = [
            int(a.current_value)
            for a in self.agents.values()
            if not a.is_byzantine and a.current_value is not None
        ]
        if not honest_values:
            return False, 0.0

        honest_initials = [
            int(a.initial_value)
            for a in self.agents.values()
            if not a.is_byzantine and a.initial_value is not None
        ]

        if len(honest_values) == 1:
            return (honest_values[0] in honest_initials), 100.0

        top_value, count = Counter(honest_values).most_common(1)[0]
        agreement_pct = count / len(honest_values) * 100
        if agreement_pct != 100.0:
            return False, agreement_pct
        if top_value not in honest_initials:
            return False, agreement_pct
        return True, agreement_pct

    # ----------------------------------------------------------------- votes

    def get_all_termination_votes(
        self, agent_votes: Dict[str, Optional[bool]]
    ) -> Dict:
        """Tally stop/continue/abstain votes, split by role.

        Vote encoding: True=stop, False=continue, None=abstain.
        Reference: byzantine_consensus.py:251-312.
        """
        def ids(pred) -> List[str]:
            return [aid for aid, v in agent_votes.items() if pred(aid, v)]

        is_byz = lambda aid: self.agents[aid].is_byzantine  # noqa: E731
        stop_voters = ids(lambda a, v: v is True)
        continue_voters = ids(lambda a, v: v is False)
        abstainers = ids(lambda a, v: v is None)
        return {
            "total_stop_votes": len(stop_voters),
            "total_continue_votes": len(continue_voters),
            "total_abstentions": len(abstainers),
            "total_agents": len(agent_votes),
            "honest_stop_votes": sum(1 for a in stop_voters if not is_byz(a)),
            "byzantine_stop_votes": sum(1 for a in stop_voters if is_byz(a)),
            "honest_abstentions": sum(1 for a in abstainers if not is_byz(a)),
            "byzantine_abstentions": sum(1 for a in abstainers if is_byz(a)),
            "stop_voters": stop_voters,
            "continue_voters": continue_voters,
            "abstaining_voters": abstainers,
            "honest_stop_voters": [a for a in stop_voters if not is_byz(a)],
            "byzantine_stop_voters": [a for a in stop_voters if is_byz(a)],
            "honest_abstaining": [a for a in abstainers if not is_byz(a)],
            "byzantine_abstaining": [a for a in abstainers if is_byz(a)],
        }

    def check_and_record_half_stop_milestone(
        self, agent_votes: Dict[str, Optional[bool]]
    ) -> None:
        """Capture a rich snapshot the first time >=1/2 of ALL agents vote
        stop (reference byzantine_consensus.py:314-371)."""
        if self.first_half_stop_reached:
            return
        info = self.get_all_termination_votes(agent_votes)
        total_stop, total = info["total_stop_votes"], info["total_agents"]
        if total == 0 or total_stop < total / 2:
            return
        self.first_half_stop_reached = True
        has_consensus, agreement_pct = self.check_consensus()
        self.first_half_stop_info = {
            "round": self.current_round,
            "total_stop_votes": total_stop,
            "total_continue_votes": info["total_continue_votes"],
            "total_abstentions": info["total_abstentions"],
            "total_agents": total,
            "stop_percentage": total_stop / total * 100,
            "stop_voters": info["stop_voters"],
            "continue_voters": info["continue_voters"],
            "abstaining_voters": info["abstaining_voters"],
            "honest_stop_votes": info["honest_stop_votes"],
            "honest_stop_voters": info["honest_stop_voters"],
            "byzantine_stop_votes": info["byzantine_stop_votes"],
            "byzantine_stop_voters": info["byzantine_stop_voters"],
            "honest_abstentions": info["honest_abstentions"],
            "honest_abstaining": info["honest_abstaining"],
            "byzantine_abstentions": info["byzantine_abstentions"],
            "byzantine_abstaining": info["byzantine_abstaining"],
            "had_consensus_at_milestone": has_consensus,
            "agreement_percentage_at_milestone": agreement_pct,
            "agent_values_at_milestone": {
                aid: a.current_value for aid, a in self.agents.items()
            },
        }

    def should_terminate_by_vote(self, agent_votes: Dict[str, Optional[bool]]) -> bool:
        """Terminate when stop votes reach a 2/3 supermajority of ALL agents
        (hardcoded, like the reference byzantine_consensus.py:373-398 — the
        reported ``consensus_threshold`` is not consulted here)."""
        info = self.get_all_termination_votes(agent_votes)
        total = info["total_agents"]
        if total == 0:
            return False
        return info["total_stop_votes"] >= (2 * total) / 3

    # ----------------------------------------------------------- round cycle

    def record_round(self) -> None:
        """Record per-round aggregates (reference byzantine_consensus.py:400-464)."""
        honest = [
            a.current_value
            for a in self.agents.values()
            if not a.is_byzantine and a.current_value is not None
        ]
        byz = [
            a.current_value
            for a in self.agents.values()
            if a.is_byzantine and a.current_value is not None
        ]
        everyone = honest + byz

        has_consensus, agreement_pct = self.check_consensus()
        honest_ints = [int(v) for v in honest]
        if honest_ints:
            consensus_value, agreement_count = Counter(honest_ints).most_common(1)[0]
        else:
            consensus_value, agreement_count = None, 0

        self.rounds.append(
            ConsensusRound(
                round_num=self.current_round,
                agent_values={aid: a.current_value for aid, a in self.agents.items()},
                honest_values=honest,
                byzantine_values=byz,
                honest_mean=mean(honest) if honest else 0.0,
                honest_median=median(honest) if honest else 0,
                honest_std=stdev(honest) if len(honest) > 1 else 0.0,
                all_mean=mean(everyone) if everyone else 0.0,
                all_std=stdev(everyone) if len(everyone) > 1 else 0.0,
                convergence_metric=agreement_pct,
                has_consensus=has_consensus,
                consensus_value=consensus_value,
                agreement_count=agreement_count,
            )
        )

    def advance_round(self, agent_votes: Optional[Dict[str, Optional[bool]]] = None) -> None:
        """Apply proposals, record the round, then resolve termination.

        Termination ladder (reference byzantine_consensus.py:466-518):

        1. 2/3 stop vote  -> game over; win iff the recorded round has valid
           consensus ("vote_with_consensus"), else loss
           ("vote_without_consensus").
        2. Round counter passes ``max_rounds`` -> "max_rounds"; the deadline
           ALWAYS loses, even if the final values agree.
        """
        self.apply_proposals()
        self.record_round()

        if agent_votes:
            self.check_and_record_half_stop_milestone(agent_votes)

        if agent_votes and self.should_terminate_by_vote(agent_votes):
            self.game_over = True
            last = self.rounds[-1] if self.rounds else None
            if last is not None and last.has_consensus:
                self.consensus_reached = True
                self.consensus_value = last.consensus_value
                self.honest_agents_won = True
                self.termination_reason = "vote_with_consensus"
            else:
                self.consensus_reached = False
                self.honest_agents_won = False
                self.termination_reason = "vote_without_consensus"
            return

        self.current_round += 1
        if self.current_round > self.max_rounds:
            self.game_over = True
            self.termination_reason = "max_rounds"
            self.consensus_reached = False
            self.consensus_value = None
            self.honest_agents_won = False

    def get_game_state(self) -> Dict:
        """Agent-visible game state.  The ``is_byzantine`` flag is omitted
        (reference byzantine_consensus.py:520-542).  Note a parity-preserved
        leak: ``initial_value is None`` still identifies Byzantine agents;
        the reference has the identical property and its prompt layer never
        feeds per-agent initial values to other agents, which is what keeps
        identities hidden in practice."""
        return {
            "round": self.current_round,
            "num_honest": self.num_honest,
            "num_byzantine": self.num_byzantine,
            "max_rounds": self.max_rounds,
            "rounds_until_deadline": max(0, self.max_rounds - self.current_round),
            "game_over": self.game_over,
            "consensus_reached": self.consensus_reached,
            "consensus_value": self.consensus_value,
            "honest_agents_won": self.honest_agents_won,
            "agent_states": {
                aid: {
                    "initial_value": a.initial_value,
                    "current_value": a.current_value,
                    "proposed_value": a.proposed_value,
                }
                for aid, a in self.agents.items()
            },
        }

    def get_statistics(self) -> Dict:
        from bcg_tpu_torch.game.statistics import compute_statistics

        return compute_statistics(self)

    # ------------------------------------------------------------ checkpoint

    def snapshot(self) -> Dict:
        """Serialize full game state for per-round checkpoint/resume (the
        reference has no checkpointing; SURVEY.md §5.4)."""
        return {
            "num_honest": self.num_honest,
            "num_byzantine": self.num_byzantine,
            "value_range": list(self.value_range),
            "consensus_threshold": self.consensus_threshold,
            "max_rounds": self.max_rounds,
            "rng_state": self.rng.getstate(),
            "agents": {aid: a.snapshot() for aid, a in self.agents.items()},
            "rounds": [r.snapshot() for r in self.rounds],
            "current_round": self.current_round,
            "game_over": self.game_over,
            "consensus_reached": self.consensus_reached,
            "consensus_value": self.consensus_value,
            "honest_agents_won": self.honest_agents_won,
            "termination_reason": self.termination_reason,
            "first_half_stop_reached": self.first_half_stop_reached,
            "first_half_stop_info": (
                dict(self.first_half_stop_info) if self.first_half_stop_info else None
            ),
            "all_reasoning": [
                {"round": e["round"], "reasoning": dict(e["reasoning"])}
                for e in self.all_reasoning
            ],
        }

    @classmethod
    def from_snapshot(cls, data: Dict) -> "ByzantineConsensusGame":
        game = cls.__new__(cls)
        game.num_honest = data["num_honest"]
        game.num_byzantine = data["num_byzantine"]
        game.total_agents = game.num_honest + game.num_byzantine
        game.value_range = tuple(data["value_range"])
        game.consensus_threshold = data["consensus_threshold"]
        game.max_rounds = data["max_rounds"]
        game.rng = random.Random()
        state = data["rng_state"]
        # JSON round-trips tuples as lists; random.setstate needs tuples.
        game.rng.setstate((state[0], tuple(state[1]), state[2]))
        game.agents = {
            aid: AgentState.from_snapshot(s) for aid, s in data["agents"].items()
        }
        game.rounds = [ConsensusRound.from_snapshot(r) for r in data["rounds"]]
        game.current_round = data["current_round"]
        game.game_over = data["game_over"]
        game.consensus_reached = data["consensus_reached"]
        game.consensus_value = data["consensus_value"]
        game.honest_agents_won = data["honest_agents_won"]
        game.termination_reason = data["termination_reason"]
        game.first_half_stop_reached = data["first_half_stop_reached"]
        game.first_half_stop_info = data["first_half_stop_info"]
        game.all_reasoning = data["all_reasoning"]
        return game
