"""Abstract communication-protocol interfaces.

Contract parity with the reference ``communication_protocol.py:14-217``:
any protocol implementing these ABCs plugs into :class:`AgentNetwork`
unchanged.  Messages must be hashable/equatable for duplicate suppression
and serializable for deterministic logging.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, List


class Message(ABC):
    """Base message: point-to-point routed, round-stamped, dedupable.

    Required attributes: ``sender_id``, ``receiver_id``, ``round``
    (reference communication_protocol.py:14-27).
    """

    sender_id: int
    receiver_id: int
    round: int

    @abstractmethod
    def to_dict(self) -> Dict[str, Any]:
        """Serialize to a JSON-compatible dict."""

    @classmethod
    @abstractmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Message":
        """Deserialize from :meth:`to_dict` output."""

    @abstractmethod
    def __hash__(self):  # pragma: no cover - interface
        ...

    @abstractmethod
    def __eq__(self, other):  # pragma: no cover - interface
        ...


class ProtocolClient(ABC):
    """Per-agent handle onto a shared protocol instance
    (reference communication_protocol.py:63-128)."""

    def __init__(self, agent_id: int, protocol: "CommunicationProtocol"):
        self.agent_id = agent_id
        self.protocol = protocol

    @abstractmethod
    def receive_messages(self, round: int) -> List[Message]:
        """Fetch this agent's inbox for ``round``."""

    @abstractmethod
    def send_to_neighbors(self, round: int, **kwargs) -> None:
        """Broadcast protocol-specific content to all neighbours."""

    @abstractmethod
    def get_neighbors(self) -> List[int]:
        """Neighbour set N_i."""

    @abstractmethod
    def get_history(self) -> List[Dict[str, Any]]:
        """Persistent per-agent conversation history H_i."""

    @abstractmethod
    def reset(self) -> None:
        """Clear client state for a fresh simulation."""


class CommunicationProtocol(ABC):
    """Shared router over a static topology
    (reference communication_protocol.py:131-217)."""

    def __init__(self, num_agents: int, topology: Dict[int, List[int]]):
        self.num_agents = num_agents
        self.topology = topology

    @abstractmethod
    def create_client(self, agent_id: int) -> ProtocolClient:
        ...

    @abstractmethod
    def send_message(self, sender_id: int, receiver_id: int, message: Message) -> None:
        ...

    @abstractmethod
    def deliver_messages(self, agent_id: int, round: int) -> List[Message]:
        ...

    @abstractmethod
    def get_neighbors(self, agent_id: int) -> List[int]:
        ...

    @abstractmethod
    def reset(self) -> None:
        ...

    def get_message_count(self, round: int) -> int:
        """Messages buffered for ``round`` (optional metric hook)."""
        return 0

    def get_total_message_count(self) -> int:
        """Total messages across the whole run (optional metric hook)."""
        return 0
