"""Fault injection for resilience experiments (SURVEY.md §5.3).

The reference's only fault model is the Byzantine agents themselves; its
LLM-failure handling (the 3-attempt retry ladder, orchestrator batch
retry → sequential fallback, abstain/CONTINUE degradation —
main.py:269-341, bcg_agents.py:708-759) can only be exercised by hoping a
model misbehaves.  :class:`FaultInjectingEngine` makes that machinery a
controlled experimental axis: it wraps any engine and corrupts a seeded
fraction of responses, so resilience-vs-fault-rate curves are measurable
and the degradation path is testable end-to-end on real runs.

Enable with ``--fault-rate 0.2 --fault-seed 7`` or
``EngineConfig(fault_rate=0.2)``.
"""

from __future__ import annotations

import random
from typing import Any, Dict

from bcg_tpu_torch.engine.interface import InferenceEngine
from bcg_tpu_torch.obs import counters as obs_counters

# Corruption modes, mirroring real LLM failure classes the validity
# predicates screen for (orchestrator._is_valid_*): error dicts (engine
# failure), missing fields, wrong types, and too-short content.
_MODES = ("error_dict", "drop_field", "wrong_type", "short_content")


class FaultInjectingEngine(InferenceEngine):
    """Corrupt a seeded fraction of guided responses from the inner engine."""

    def __init__(self, engine: InferenceEngine, rate: float, seed: int = 0):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"fault_rate={rate} outside [0, 1]")
        self._engine = engine
        self.rate = rate
        self.rng = random.Random(seed)
        self.injected = 0  # observability: total corrupted responses

    # ------------------------------------------------------------ corruption

    # Fields the orchestrator's validity predicates actually check
    # (decision/value/internal_strategy are structurally required for
    # every game schema; public_reasoning is NOT checked for Byzantine
    # decisions) — corruptions target these so every injection is a real
    # fault, keeping the effective rate equal to the nominal rate.
    _CHECKED = ("decision", "value", "internal_strategy")

    def _corrupt(self, result: Dict[str, Any]) -> Dict[str, Any]:
        self.injected += 1
        # Registry twin of the instance attribute: `self.injected` is
        # invisible to /metrics, the fleet shard merge, and bench JSON —
        # the counter makes every corrupted response a first-class
        # observable like the chaos injector's chaos.injected.
        obs_counters.inc("engine.faults.injected")
        mode = self.rng.choice(_MODES)
        if mode == "error_dict" or not isinstance(result, dict) or not result:
            return {"error": "injected_fault"}
        out = dict(result)
        checked = [k for k in self._CHECKED if k in out] or list(out.keys())
        if mode == "drop_field":
            out.pop(self.rng.choice(checked))
        elif mode == "wrong_type":
            out[self.rng.choice(checked)] = ["not", "the", "right", "type"]
        else:  # short_content: truncate every string below validity minimums
            for k, v in out.items():
                if isinstance(v, str):
                    out[k] = v[:1]
        return out

    # --------------------------------------------------- InferenceEngine API

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        results = self._engine.batch_generate_json(prompts, temperature, max_tokens)
        return [
            self._corrupt(r) if self.rng.random() < self.rate else r
            for r in results
        ]

    def generate_json(self, prompt, schema, temperature=0.0, max_tokens=512,
                      system_prompt=None) -> Dict[str, Any]:
        result = self._engine.generate_json(
            prompt, schema, temperature, max_tokens, system_prompt=system_prompt
        )
        if self.rng.random() < self.rate:
            return self._corrupt(result)
        return result

    def generate(self, prompt, temperature=0.0, max_tokens=256, top_p=1.0,
                 system_prompt=None) -> str:
        return self._engine.generate(
            prompt, temperature, max_tokens, top_p, system_prompt=system_prompt
        )

    def batch_generate(self, prompts, temperature=0.0, max_tokens=256, top_p=1.0):
        return self._engine.batch_generate(prompts, temperature, max_tokens, top_p)

    def shutdown(self) -> None:
        self._engine.shutdown()
