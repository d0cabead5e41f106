"""Protocol factory (reference ``protocol_factory.py:11-44``).

Registry-based so downstream code can plug new protocols without editing
this module (the reference hardcodes the single known type).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from bcg_tpu_torch.comm.a2a_sim import A2ASimProtocol
from bcg_tpu_torch.comm.protocol import CommunicationProtocol

_REGISTRY: Dict[str, Callable[..., CommunicationProtocol]] = {}


def register_protocol(name: str, builder: Callable[..., CommunicationProtocol]) -> None:
    _REGISTRY[name] = builder


def create_protocol(
    protocol_type: str,
    num_agents: int,
    topology: Dict[int, List[int]],
    config: Optional[dict] = None,
) -> CommunicationProtocol:
    """Instantiate a registered protocol by name.

    Raises ``ValueError`` listing known protocols for unknown names
    (reference protocol_factory.py:40-44).
    """
    try:
        builder = _REGISTRY[protocol_type]
    except KeyError:
        raise ValueError(
            f"Unknown protocol type: {protocol_type!r}. "
            f"Available: {sorted(_REGISTRY)}"
        ) from None
    return builder(num_agents=num_agents, topology=topology, config=config or {})


def _build_lossy(num_agents, topology, config):
    from bcg_tpu_torch.comm.lossy_sim import LossySimProtocol

    return LossySimProtocol(
        num_agents,
        topology,
        drop_prob=config.get("drop_prob", 0.0),
        delay_prob=config.get("delay_prob", 0.0),
        max_delay_rounds=config.get("max_delay_rounds", 1),
        seed=config.get("seed", 0),  # None = unseeded (fresh entropy)
    )


register_protocol(
    "a2a_sim",
    lambda num_agents, topology, config: A2ASimProtocol(num_agents, topology),
)
register_protocol("lossy_sim", _build_lossy)
