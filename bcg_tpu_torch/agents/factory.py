"""Agent factory (reference ``bcg_agents.py:1402-1441``)."""

from __future__ import annotations

from typing import Optional, Tuple

from bcg_tpu_torch.agents.base import BCGAgent
from bcg_tpu_torch.agents.byzantine import ByzantineBCGAgent
from bcg_tpu_torch.agents.honest import HonestBCGAgent
from bcg_tpu_torch.config import LLMConfig
from bcg_tpu_torch.engine.interface import InferenceEngine


def create_agent(
    agent_id: str,
    is_byzantine: bool,
    engine: InferenceEngine,
    value_range: Tuple[int, int],
    byzantine_awareness: str = "may_exist",
    llm_config: LLMConfig = LLMConfig(),
    strategy: Optional[str] = None,
    strategy_seed: Optional[int] = None,
) -> BCGAgent:
    cls = ByzantineBCGAgent if is_byzantine else HonestBCGAgent
    return cls(
        agent_id=agent_id,
        is_byzantine=is_byzantine,
        engine=engine,
        value_range=value_range,
        byzantine_awareness=byzantine_awareness,
        max_json_retries=llm_config.max_json_retries,
        temperature_decide=llm_config.temperature_decide,
        temperature_vote=llm_config.temperature_vote,
        max_tokens_decide=llm_config.max_tokens_decide,
        max_tokens_vote=llm_config.max_tokens_vote,
        # Adversary-library strategy (scenarios/): only the Byzantine
        # prompt layer reads it, but it rides the shared ctor.
        strategy=strategy if is_byzantine else None,
        strategy_seed=strategy_seed,
    )
