"""Agent communication layer.

Pluggable protocols over static network topologies, cloned behaviourally
from the reference's ``communication_protocol.py`` / ``a2a_sim.py`` /
``agent_network.py`` / ``protocol_factory.py``.
"""

from bcg_tpu_torch.comm.protocol import Message, ProtocolClient, CommunicationProtocol
from bcg_tpu_torch.comm.a2a_sim import (
    Phase,
    DecisionType,
    Decision,
    A2AMessage,
    A2ASimProtocol,
    A2ASimClient,
)
from bcg_tpu_torch.comm.topology import NetworkTopology
from bcg_tpu_torch.comm.network import AgentNetwork
from bcg_tpu_torch.comm.factory import create_protocol, register_protocol

__all__ = [
    "Message",
    "ProtocolClient",
    "CommunicationProtocol",
    "Phase",
    "DecisionType",
    "Decision",
    "A2AMessage",
    "A2ASimProtocol",
    "A2ASimClient",
    "NetworkTopology",
    "AgentNetwork",
    "create_protocol",
    "register_protocol",
]
