"""LLM-driven game agents (reference ``bcg_agents.py``).

One shared inference engine serves every agent; agents differ only in
their :class:`AgentMemory` contents and role-specific prompts, never in
weights (reference bcg_agents.py:32-38).
"""

from bcg_tpu_torch.agents.state import AgentMemory, MAX_HISTORY_ROUNDS
from bcg_tpu_torch.agents.base import BCGAgent
from bcg_tpu_torch.agents.honest import HonestBCGAgent
from bcg_tpu_torch.agents.byzantine import ByzantineBCGAgent
from bcg_tpu_torch.agents.factory import create_agent

__all__ = [
    "AgentMemory",
    "MAX_HISTORY_ROUNDS",
    "BCGAgent",
    "HonestBCGAgent",
    "ByzantineBCGAgent",
    "create_agent",
]
