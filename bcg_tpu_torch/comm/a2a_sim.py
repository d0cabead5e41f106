"""A2A-Sim protocol: synchronous, idealized agent-to-agent messaging.

Behavioural clone of the reference ``a2a_sim.py``:

* static undirected graph, neighbour-only routing with validation
* dual payload — structured :class:`Decision` + free-text reasoning capped
  at 500 chars
* per-round buffered delivery; all round-t messages arrive before t+1
* duplicate suppression keyed on (sender, receiver, round, phase, timestamp)
* inbox ordering by (sender_id, timestamp)

Improvement over the reference: the orchestrator actually calls
``clear_round_buffer`` each round (the reference defines it at
a2a_sim.py:235-244 but never calls it, so buffers grow for the whole run).
The aggregate message count survives clearing via a per-round counter.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Set

from bcg_tpu_torch.comm.protocol import CommunicationProtocol, Message, ProtocolClient

REASONING_CHAR_LIMIT = 500  # a2a_sim.py:69-73


def truncate_reasoning(text: str) -> str:
    """The protocol's reasoning cap (reference a2a_sim.py:69-73) — the
    single definition both the message type and the SPMD exchange path
    use, so the two delivery paths stay byte-identical."""
    if len(text) > REASONING_CHAR_LIMIT:
        return text[: REASONING_CHAR_LIMIT - 3] + "..."
    return text


class Phase(str, Enum):
    """Protocol phases (reference a2a_sim.py:20-26)."""

    PROPOSE = "propose"
    PREPARE = "prepare"
    COMMIT = "commit"
    CUSTOM = "custom"


class DecisionType(str, Enum):
    """Structured decision kinds (reference a2a_sim.py:28-32)."""

    VALUE = "value"
    VOTE = "vote"
    ABSTAIN = "abstain"


@dataclass
class Decision:
    """Machine-readable action part of a message (reference a2a_sim.py:35-46)."""

    type: str
    value: Any

    def to_dict(self) -> Dict[str, Any]:
        return {"type": self.type, "value": self.value}

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Decision":
        return cls(type=data["type"], value=data["value"])


@dataclass
class A2AMessage(Message):
    """Dual-payload message (reference a2a_sim.py:49-113).

    Carries both a structured decision and the sender's public reasoning;
    the timestamp is a per-sender monotonic counter used for total ordering
    and duplicate suppression.
    """

    sender_id: int
    receiver_id: int
    round: int
    phase: str
    decision: Decision
    reasoning: str
    timestamp: int

    def __post_init__(self):
        self.reasoning = truncate_reasoning(self.reasoning)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "sender_id": self.sender_id,
            "receiver_id": self.receiver_id,
            "round": self.round,
            "phase": self.phase,
            "decision": self.decision.to_dict(),
            "reasoning": self.reasoning,
            "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "A2AMessage":
        return cls(
            sender_id=data["sender_id"],
            receiver_id=data["receiver_id"],
            round=data["round"],
            phase=data["phase"],
            decision=Decision.from_dict(data["decision"]),
            reasoning=data["reasoning"],
            timestamp=data["timestamp"],
        )

    def _key(self):
        return (self.sender_id, self.receiver_id, self.round, self.phase, self.timestamp)

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, A2AMessage) and self._key() == other._key()


class A2ASimProtocol(CommunicationProtocol):
    """Round-buffered router over a static graph (reference a2a_sim.py:116-298)."""

    def __init__(self, num_agents: int, topology: Dict[int, List[int]]):
        super().__init__(num_agents, topology)
        # round -> receiver_id -> inbox list
        self.message_buffer: Dict[int, Dict[int, List[A2AMessage]]] = {}
        self.delivered: Set[A2AMessage] = set()
        # round -> count, survives clear_round_buffer so aggregate metrics
        # stay correct even with per-round GC.
        self._round_counts: Dict[int, int] = {}
        self.current_round = 0
        self.current_phase = Phase.PROPOSE.value

    def send_message(self, sender_id: int, receiver_id: int, message: A2AMessage) -> None:
        """Buffer a point-to-point message after neighbour validation and
        duplicate suppression (reference a2a_sim.py:157-181).

        Validation, dedup, and the sent-count are the CHANNEL-INDEPENDENT
        contract; delivery itself goes through :meth:`_route` so
        subclasses (e.g. the lossy channel) override only the routing
        decision.
        """
        if receiver_id not in self.topology.get(sender_id, []):
            raise ValueError(
                f"Agent {sender_id} cannot send to {receiver_id}: not in neighbor set"
            )
        if message in self.delivered:
            return
        self.delivered.add(message)
        self._round_counts[message.round] = self._round_counts.get(message.round, 0) + 1
        self._route(receiver_id, message)

    def _route(self, receiver_id: int, message: A2AMessage) -> None:
        """Deliver into the receiver's inbox for the message's round
        (ideal channel: on time, always)."""
        self.message_buffer.setdefault(message.round, {}).setdefault(
            receiver_id, []
        ).append(message)

    def broadcast_to_neighbors(
        self,
        sender_id: int,
        round: int,
        phase: str,
        decision: Decision,
        reasoning: str,
        timestamp: int,
    ) -> None:
        """Multicast illusion: identical content to every neighbour
        (reference a2a_sim.py:183-210)."""
        for neighbor_id in self.topology.get(sender_id, []):
            self.send_message(
                sender_id,
                neighbor_id,
                A2AMessage(
                    sender_id=sender_id,
                    receiver_id=neighbor_id,
                    round=round,
                    phase=phase,
                    decision=decision,
                    reasoning=reasoning,
                    timestamp=timestamp,
                ),
            )

    def send_per_receiver(
        self,
        sender_id: int,
        round: int,
        phase: str,
        decisions: Dict[int, Decision],
        reasoning: str,
        timestamp: int,
    ) -> None:
        """Equivocating broadcast: a DIFFERENT decision per neighbour
        under one timestamp (the adversary 'broadcasts' once; the
        channel carries receiver-addressed variants).  Neighbours
        without an entry in ``decisions`` get nothing.  Routes through
        :meth:`send_message`, so neighbour validation, dedup, counters,
        and channel overrides (lossy ``_route``) all apply per variant.
        """
        for neighbor_id in self.topology.get(sender_id, []):
            decision = decisions.get(neighbor_id)
            if decision is None:
                continue
            self.send_message(
                sender_id,
                neighbor_id,
                A2AMessage(
                    sender_id=sender_id,
                    receiver_id=neighbor_id,
                    round=round,
                    phase=phase,
                    decision=decision,
                    reasoning=reasoning,
                    timestamp=timestamp,
                ),
            )

    def deliver_messages(self, agent_id: int, round: int) -> List[A2AMessage]:
        """Inbox for (agent, round), ordered by (sender_id, timestamp)
        (reference a2a_sim.py:212-233)."""
        inbox = self.message_buffer.get(round, {}).get(agent_id, [])
        return sorted(inbox, key=lambda m: (m.sender_id, m.timestamp))

    def clear_round_buffer(self, round: int) -> None:
        """GC a completed round's buffers and delivered-set entries."""
        dropped = self.message_buffer.pop(round, None)
        if dropped:
            for inbox in dropped.values():
                for msg in inbox:
                    self.delivered.discard(msg)

    def get_neighbors(self, agent_id: int) -> List[int]:
        return self.topology.get(agent_id, [])

    def set_phase(self, round: int, phase: str) -> None:
        self.current_round = round
        self.current_phase = phase

    def get_message_count(self, round: int) -> int:
        return self._round_counts.get(round, 0)

    def get_total_message_count(self) -> int:
        """Total messages across all rounds (fixes the reference's final-
        round undercount — main.py:804-808 sums ``range(current_round)``
        against 1-indexed round keys)."""
        return sum(self._round_counts.values())

    def reset(self) -> None:
        self.message_buffer.clear()
        self.delivered.clear()
        self._round_counts.clear()
        self.current_round = 0

    # ------------------------------------------------------ checkpointing

    def snapshot(self) -> Dict:
        """JSON-serializable channel state (in-flight buffers + counters)
        for per-round checkpoint/resume.  The delivered set is derived
        from the buffered messages on restore (GC'd rounds' entries were
        already discarded)."""
        return {
            "message_buffer": {
                str(r): {
                    str(a): [m.to_dict() for m in inbox]
                    for a, inbox in boxes.items()
                }
                for r, boxes in self.message_buffer.items()
            },
            "round_counts": {str(r): c for r, c in self._round_counts.items()},
            "current_round": self.current_round,
            "current_phase": self.current_phase,
        }

    def restore(self, blob: Dict) -> None:
        self.message_buffer = {
            int(r): {
                int(a): [A2AMessage.from_dict(d) for d in inbox]
                for a, inbox in boxes.items()
            }
            for r, boxes in blob["message_buffer"].items()
        }
        self.delivered = {
            m
            for boxes in self.message_buffer.values()
            for inbox in boxes.values()
            for m in inbox
        }
        self._round_counts = {
            int(r): c for r, c in blob["round_counts"].items()
        }
        self.current_round = blob["current_round"]
        self.current_phase = blob["current_phase"]

    def create_client(self, agent_id: int) -> "A2ASimClient":
        return A2ASimClient(agent_id=agent_id, protocol=self)


class A2ASimClient(ProtocolClient):
    """Agent-side handle: send, receive, and persistent history H_i
    (reference a2a_sim.py:301-387)."""

    def __init__(self, agent_id: int, protocol: A2ASimProtocol):
        super().__init__(agent_id, protocol)
        self.protocol: A2ASimProtocol = protocol
        self.history: List[Dict[str, Any]] = []
        self._timestamp_counter = 0

    def next_timestamp(self) -> int:
        self._timestamp_counter += 1
        return self._timestamp_counter

    def receive_messages(self, round: int) -> List[A2AMessage]:
        return self.protocol.deliver_messages(self.agent_id, round)

    def send_to_neighbors(
        self, round: int, phase: str = Phase.PROPOSE.value,
        decision: Optional[Decision] = None, reasoning: str = "",
    ) -> None:
        self.protocol.broadcast_to_neighbors(
            sender_id=self.agent_id,
            round=round,
            phase=phase,
            decision=decision,
            reasoning=reasoning,
            timestamp=self.next_timestamp(),
        )

    def send_per_receiver(
        self, round: int, phase: str = Phase.PROPOSE.value,
        decisions: Optional[Dict[int, Decision]] = None, reasoning: str = "",
    ) -> None:
        """Equivocating variant of :meth:`send_to_neighbors`: one
        timestamp, per-neighbour decisions (see the protocol method)."""
        self.protocol.send_per_receiver(
            sender_id=self.agent_id,
            round=round,
            phase=phase,
            decisions=decisions or {},
            reasoning=reasoning,
            timestamp=self.next_timestamp(),
        )

    def update_history(
        self, round: int, inbox: List[A2AMessage], local_state: Dict[str, Any]
    ) -> None:
        self.history.append(
            {
                "round": round,
                "inbox": [m.to_dict() for m in inbox],
                "local_state": local_state,
            }
        )

    def get_neighbors(self) -> List[int]:
        return self.protocol.get_neighbors(self.agent_id)

    def get_history(self) -> List[Dict[str, Any]]:
        return self.history

    def reset(self) -> None:
        self.history.clear()
        self._timestamp_counter = 0
