"""Adversary library + scenario registry (ROADMAP item 2).

``strategies`` — pluggable Byzantine strategy objects (prompt persona
+ scripted FakeEngine mirror + exchange semantics); ``registry`` —
named scenario entries that expand into sweep presets and single-run
configs (``BCG_TPU_SCENARIO``).
"""

from bcg_tpu_torch.scenarios.registry import (
    SCENARIOS,
    Scenario,
    apply_scenario,
    get_scenario,
    scenario_names,
    scenario_params,
    scripted_fake_policy,
)
from bcg_tpu_torch.scenarios.strategies import (
    SCRIPTED_POLICIES,
    STRATEGIES,
    ByzantineStrategy,
    clique_target,
    equivocation_value,
    get_strategy,
    persona_block,
    strategy_names,
    task_block,
)

__all__ = [
    "SCENARIOS",
    "SCRIPTED_POLICIES",
    "STRATEGIES",
    "ByzantineStrategy",
    "Scenario",
    "apply_scenario",
    "clique_target",
    "equivocation_value",
    "get_scenario",
    "get_strategy",
    "persona_block",
    "scenario_names",
    "scenario_params",
    "scripted_fake_policy",
    "strategy_names",
    "task_block",
]
