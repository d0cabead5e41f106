"""Per-agent rolling memory (reference ``bcg_agents.py:86-131``).

Compressed state instead of full transcripts: the LLM sees only the last
few round summaries plus its own private strategy notes, which is how the
reference keeps 8K context sufficient for 50-round games (SURVEY.md §5.7).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

# Rounds kept in agent memory by default (reference bcg_agents.py:83).
MAX_HISTORY_ROUNDS = 5


@dataclass
class AgentMemory:
    """Rolling compressed memory carried across rounds."""

    last_k_rounds: List[str] = field(default_factory=list)
    last_k_internal_strategies: List[Tuple[int, str]] = field(default_factory=list)
    neighbor_stats: Dict[str, dict] = field(default_factory=dict)
    current_goal: str = "REACH_CONSENSUS"  # or DISRUPT_CONSENSUS
    local_state: Dict = field(default_factory=dict)

    def add_round_summary(self, summary: str, max_history: int = MAX_HISTORY_ROUNDS) -> None:
        self.last_k_rounds.append(summary)
        while len(self.last_k_rounds) > max_history:
            self.last_k_rounds.pop(0)

    def add_internal_strategy(
        self, round_num: int, strategy: str, max_history: int = MAX_HISTORY_ROUNDS
    ) -> None:
        self.last_k_internal_strategies.append((round_num, strategy))
        while len(self.last_k_internal_strategies) > max_history:
            self.last_k_internal_strategies.pop(0)

    def update_neighbor_stat(self, agent_id: str, value: int) -> None:
        """Track last seen value + message count per neighbour
        (reference bcg_agents.py:121-131, including its quirk of starting
        the count at 0 for the first message)."""
        stats = self.neighbor_stats.get(agent_id)
        if stats is None:
            self.neighbor_stats[agent_id] = {"last_value": value, "message_count": 0}
        else:
            stats["last_value"] = value
            stats["message_count"] = stats.get("message_count", 0) + 1

    def snapshot(self) -> Dict:
        return {
            "last_k_rounds": list(self.last_k_rounds),
            "last_k_internal_strategies": [
                list(t) for t in self.last_k_internal_strategies
            ],
            "neighbor_stats": {k: dict(v) for k, v in self.neighbor_stats.items()},
            "current_goal": self.current_goal,
            "local_state": dict(self.local_state),
        }

    @classmethod
    def from_snapshot(cls, data: Dict) -> "AgentMemory":
        mem = cls(
            last_k_rounds=list(data.get("last_k_rounds", [])),
            last_k_internal_strategies=[
                (int(r), s) for r, s in data.get("last_k_internal_strategies", [])
            ],
            neighbor_stats={k: dict(v) for k, v in data.get("neighbor_stats", {}).items()},
            current_goal=data.get("current_goal", "REACH_CONSENSUS"),
            local_state=dict(data.get("local_state", {})),
        )
        return mem
