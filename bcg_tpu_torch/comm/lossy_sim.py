"""Lossy/delayed A2A channel — an unreliable-network protocol variant.

The reference's A2A-sim assumes an idealized channel: no loss, delay, or
reordering (reference ``a2a_sim.py:127-132``), and its factory knows only
that one protocol (``protocol_factory.py:34-44``).  This variant makes
channel faults a first-class experimental axis, complementing the
LLM-response fault injection in :mod:`bcg_tpu_torch.engine.fault`:

* ``drop_prob`` — each point-to-point message is silently dropped with
  this probability (the receiver simply never sees the proposal).
* ``delay_prob`` / ``max_delay_rounds`` — a surviving message is, with
  ``delay_prob``, delivered 1..``max_delay_rounds`` rounds LATE: the
  receiver sees a stale proposal (the message's ``round`` field keeps the
  round it was decided in, so agents can in principle notice staleness —
  whether the LLM does is the research question).
* Seeded: fault rolls come from a private ``random.Random(seed)``, so a
  lossy run is exactly reproducible; ``seed=None`` draws fresh entropy
  per run, mirroring the game's own unseeded behavior.

Semantics preserved from the reliable channel (all inherited —
only the :meth:`_route` delivery decision is overridden): neighbour-set
validation still raises on invalid sends, duplicate suppression still
applies (the channel "consumes" a dropped message — retrying the
identical message is a no-op, like a lost UDP datagram), inbox ordering
stays (sender_id, timestamp), and per-round sent-message counts include
dropped messages (an interface counter, comparable across channels).

Channel fault counts surface in ``AgentNetwork.get_network_stats()``
(and from there the run's results JSON) via :meth:`get_fault_stats`.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from bcg_tpu_torch.comm.a2a_sim import A2AMessage, A2ASimProtocol


class LossySimProtocol(A2ASimProtocol):
    def __init__(
        self,
        num_agents: int,
        topology: Dict[int, List[int]],
        drop_prob: float = 0.0,
        delay_prob: float = 0.0,
        max_delay_rounds: int = 1,
        seed: Optional[int] = 0,
    ):
        if not 0.0 <= drop_prob <= 1.0:
            raise ValueError(f"drop_prob={drop_prob}: expected [0, 1]")
        if not 0.0 <= delay_prob <= 1.0:
            raise ValueError(f"delay_prob={delay_prob}: expected [0, 1]")
        if max_delay_rounds < 1:
            raise ValueError(
                f"max_delay_rounds={max_delay_rounds}: expected >= 1"
            )
        super().__init__(num_agents, topology)
        self.drop_prob = drop_prob
        self.delay_prob = delay_prob
        self.max_delay_rounds = max_delay_rounds
        self._seed = seed
        self._rng = random.Random(seed)
        self.dropped_count = 0
        self.delayed_count = 0
        # Dropped messages never join an inbox, so the parent's per-round
        # GC would never release their delivered-set entries — track them
        # by send round for clear_round_buffer.
        self._dropped_by_round: Dict[int, List[A2AMessage]] = {}

    def _route(self, receiver_id: int, message: A2AMessage) -> None:
        if self._rng.random() < self.drop_prob:
            self.dropped_count += 1
            self._dropped_by_round.setdefault(message.round, []).append(message)
            return
        delivery_round = message.round
        if self.delay_prob and self._rng.random() < self.delay_prob:
            delivery_round += self._rng.randint(1, self.max_delay_rounds)
            self.delayed_count += 1
        self.message_buffer.setdefault(delivery_round, {}).setdefault(
            receiver_id, []
        ).append(message)

    def clear_round_buffer(self, round: int) -> None:
        super().clear_round_buffer(round)
        for msg in self._dropped_by_round.pop(round, []):
            self.delivered.discard(msg)

    def get_fault_stats(self) -> Dict[str, int]:
        return {"dropped": self.dropped_count, "delayed": self.delayed_count}

    def reset(self) -> None:
        super().reset()
        self._rng = random.Random(self._seed)
        self.dropped_count = 0
        self.delayed_count = 0
        self._dropped_by_round.clear()

    # ------------------------------------------------------ checkpointing

    def snapshot(self) -> Dict:
        """Extends the base channel snapshot with the fault-RNG stream
        position, counters, and dropped-message GC bookkeeping, so a
        resumed lossy run replays the EXACT fault sequence an
        uninterrupted seeded run would have seen (in-flight delayed
        messages ride in the base message_buffer snapshot)."""
        blob = super().snapshot()
        version, state, gauss = self._rng.getstate()
        blob["lossy"] = {
            "rng_state": [version, list(state), gauss],
            "dropped_count": self.dropped_count,
            "delayed_count": self.delayed_count,
            "dropped_by_round": {
                str(r): [m.to_dict() for m in msgs]
                for r, msgs in self._dropped_by_round.items()
            },
        }
        return blob

    def restore(self, blob: Dict) -> None:
        super().restore(blob)
        lossy = blob.get("lossy")
        if lossy is None:  # checkpoint from a reliable-channel run
            return
        version, state, gauss = lossy["rng_state"]
        self._rng.setstate((version, tuple(state), gauss))
        self.dropped_count = lossy["dropped_count"]
        self.delayed_count = lossy["delayed_count"]
        self._dropped_by_round = {
            int(r): [A2AMessage.from_dict(d) for d in msgs]
            for r, msgs in lossy["dropped_by_round"].items()
        }
        # Dropped messages hold delivered-set entries too (dedup).
        for msgs in self._dropped_by_round.values():
            self.delivered.update(msgs)
