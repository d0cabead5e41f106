"""Agent network facade (reference ``agent_network.py:90-237``).

Maps string agent ids to protocol integer indices, creates one protocol
client per agent, and exposes broadcast/receive round-level operations to
the orchestrator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from bcg_tpu_torch.comm.a2a_sim import Decision, Phase
from bcg_tpu_torch.comm.protocol import CommunicationProtocol, Message, ProtocolClient
from bcg_tpu_torch.comm.topology import NetworkTopology


class AgentNetwork:
    def __init__(
        self,
        topology: NetworkTopology,
        protocol: CommunicationProtocol,
        agents: Optional[Dict[str, Any]] = None,
    ):
        self.topology = topology
        self.num_agents = topology.num_agents
        self.protocol = protocol
        self.agents: Dict[str, Any] = agents or {}
        self.agent_id_to_index: Dict[str, int] = {}
        self.index_to_agent_id: Dict[int, str] = {}
        self.clients: Dict[str, ProtocolClient] = {}
        self.current_round = 0

    def register_agent(self, agent_id: str, agent: Any, agent_index: int) -> None:
        """Register an agent and hand it a protocol client
        (reference agent_network.py:126-145)."""
        self.agents[agent_id] = agent
        self.agent_id_to_index[agent_id] = agent_index
        self.index_to_agent_id[agent_index] = agent_id
        client = self.protocol.create_client(agent_index)
        self.clients[agent_id] = client
        if hasattr(agent, "set_a2a_client"):
            agent.set_a2a_client(client)

    def broadcast_message(
        self,
        sender_id: str,
        round_num: int,
        phase: Phase,
        decision: Decision,
        reasoning: str,
    ) -> None:
        self.clients[sender_id].send_to_neighbors(
            round=round_num,
            phase=phase.value if isinstance(phase, Phase) else phase,
            decision=decision,
            reasoning=reasoning,
        )

    def send_per_receiver(
        self,
        sender_id: str,
        round_num: int,
        phase: Phase,
        decisions_by_index: Dict[int, Decision],
        reasoning: str,
    ) -> None:
        """Equivocating broadcast: per-receiver decisions keyed by agent
        INDEX (the exchange layer's receiver indexing), one timestamp —
        see ``A2ASimClient.send_per_receiver``."""
        self.clients[sender_id].send_per_receiver(
            round=round_num,
            phase=phase.value if isinstance(phase, Phase) else phase,
            decisions=decisions_by_index,
            reasoning=reasoning,
        )

    def get_messages(
        self, receiver_id: str, round_num: int, phase: Optional[Phase] = None
    ) -> List[Message]:
        """Fetch an agent's round inbox.  ``phase`` is accepted for parity
        with the reference signature but unused by A2A-sim delivery
        (reference agent_network.py:177-195)."""
        return self.clients[receiver_id].receive_messages(round=round_num)

    def advance_round(self) -> None:
        self.current_round += 1

    def end_round_gc(self, round_num: int) -> None:
        """Release a finished round's message buffers (fixes the reference's
        unbounded buffer growth; see a2a_sim.py:235-244 never being called)."""
        if hasattr(self.protocol, "clear_round_buffer"):
            self.protocol.clear_round_buffer(round_num)

    def get_conversation_history(
        self, agent_id: str, max_messages: Optional[int] = None
    ) -> List[Dict[str, Any]]:
        history = self.clients[agent_id].get_history()
        return history[-max_messages:] if max_messages else history

    def get_network_stats(self) -> Dict[str, Any]:
        total_messages = self.protocol.get_total_message_count()
        stats = {
            "num_agents": self.num_agents,
            "topology_type": self.topology.topology_type,
            "current_round": self.current_round,
            "total_messages": total_messages,
            "avg_degree": self.topology.avg_degree,
        }
        # Unreliable channels (comm/lossy_sim.py) report their fault
        # counts so lossy experiments can attribute outcomes to actual
        # realized losses, not just the configured probabilities.
        fault_stats = getattr(self.protocol, "get_fault_stats", None)
        if fault_stats is not None:
            for k, v in fault_stats().items():
                stats[f"channel_{k}"] = v
        return stats
