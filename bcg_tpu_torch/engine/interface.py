"""Engine interface: the contract the reference implements at
``vllm_agent.py:159-504`` (generate / generate_json / batch_generate_json /
batch_generate / shutdown), re-designed as an ABC with engines injected
rather than inherited-from, so game logic is testable without any
accelerator.
"""

from __future__ import annotations

import json
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union


@dataclass
class GenerationRequest:
    """One structured-generation request: chat prompt pair + JSON schema."""

    system_prompt: str
    user_prompt: str
    schema: Optional[Dict[str, Any]] = None
    extra: Dict[str, Any] = field(default_factory=dict)


def per_row_settings(value, n: int, cast) -> List:
    """Normalize a scalar-or-sequence sampling setting (the
    :class:`InferenceEngine` batch contract) to a length-``n`` list."""
    if isinstance(value, (list, tuple)):
        vals = [cast(v) for v in value]
        if len(vals) != n:
            raise ValueError(
                f"per-row setting has {len(vals)} entries for a batch of {n}"
            )
        return vals
    return [cast(value)] * n


class InferenceEngine(ABC):
    """Shared LLM serving all agents (single weights, many prompts)."""

    @abstractmethod
    def generate(
        self,
        prompt: str,
        temperature: float = 0.0,
        max_tokens: int = 256,
        top_p: float = 1.0,
        system_prompt: Optional[str] = None,
    ) -> str:
        """Free-text generation for a single prompt."""

    @abstractmethod
    def batch_generate(
        self,
        prompts: List[str],
        temperature: Union[float, Sequence[float]] = 0.0,
        max_tokens: Union[int, Sequence[int]] = 256,
        top_p: float = 1.0,
    ) -> List[str]:
        """Free-text generation for a padded batch of prompts.

        ``temperature`` / ``max_tokens`` may be scalars or per-row
        sequences (len == len(prompts)); the collective proxy merges calls
        with different settings into one batch, so implementations MUST
        accept both forms (ignoring them entirely, like the fake engine,
        also satisfies the contract)."""

    @abstractmethod
    def generate_json(
        self,
        prompt: str,
        schema: Dict[str, Any],
        temperature: float = 0.0,
        max_tokens: int = 512,
        system_prompt: Optional[str] = None,
    ) -> Dict[str, Any]:
        """Schema-guided JSON generation.  Returns the parsed object, or a
        dict with an ``"error"`` key on failure (contract of reference
        vllm_agent.py:294-379 — callers branch on ``"error" in result``)."""

    @abstractmethod
    def batch_generate_json(
        self,
        prompts: List[Tuple[str, str, Dict[str, Any]]],
        temperature: Union[float, Sequence[float]] = 0.8,
        max_tokens: Union[int, Sequence[int]] = 512,
    ) -> List[Dict[str, Any]]:
        """Batched schema-guided generation over (system, user, schema)
        tuples.  ``user`` is a plain string, or a ``(shared_core, tail)``
        pair — engines with KV prefix caching may serve the core (a
        segment identical across rows of a role, e.g. the vote phase's
        proposals block) from a shared cached prefix; engines without
        simply join the pair.  Unlike the reference (vllm_agent.py:417-455,
        which falls back to sequential calls when schemas differ),
        implementations here are expected to batch heterogeneous schemas
        via per-sequence DFA masks.  ``temperature`` / ``max_tokens`` may
        be scalars or per-row sequences — see :meth:`batch_generate`."""

    def shutdown(self) -> None:
        """Release device resources (reference vllm_agent.py:506-551)."""

    # ---------------------------------------------------------------- helpers

    @staticmethod
    def extract_json(text: str) -> Optional[Dict[str, Any]]:
        """Brace-matching JSON salvage (reference vllm_agent.py:457-472)."""
        start = text.find("{")
        if start < 0:
            return None
        depth = 0
        in_string = False
        escaped = False
        for i in range(start, len(text)):
            ch = text[i]
            if in_string:
                if escaped:
                    escaped = False
                elif ch == "\\":
                    escaped = True
                elif ch == '"':
                    in_string = False
                continue
            if ch == '"':
                in_string = True
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    try:
                        return json.loads(text[start : i + 1])
                    except (json.JSONDecodeError, ValueError):
                        return None
        return None


def create_engine(engine_config, llm_config=None, device=None) -> InferenceEngine:
    """Build an engine from :class:`bcg_tpu_torch.config.EngineConfig`:
    ``backend="torch"`` is :class:`TorchEngine` on ``device`` (the torch
    device; ``None`` means CUDA), ``"fake"`` the deterministic
    :class:`FakeEngine`; a fault rate wraps either in
    :class:`FaultInjectingEngine`.  A mesh (``tensor_/sequence_/
    data_parallel_size``) serves every engine :class:`TorchEngine` serves
    on one device but two, which it refuses with the JAX engine's
    ``ValueError``: a paged pool with ``sp`` and a dense int4 cache with
    ``sp``."""
    from bcg_tpu_torch.runtime import envflags

    # Env overrides (BCG_TPU_FAULT_RATE / BCG_TPU_FAULT_SEED) win over
    # the config fields — the bench/sweep convention every other
    # experimental axis follows (BCG_TPU_SPEC, BCG_TPU_PAGED_KV, ...).
    fault_rate = engine_config.fault_rate
    raw_rate = envflags.get_str("BCG_TPU_FAULT_RATE")
    if raw_rate:
        try:
            fault_rate = float(raw_rate)
        except ValueError:
            raise ValueError(
                f"BCG_TPU_FAULT_RATE={raw_rate!r} is not a float"
            ) from None
    fault_seed = (
        envflags.get_int("BCG_TPU_FAULT_SEED")
        if envflags.is_set("BCG_TPU_FAULT_SEED")
        else engine_config.fault_seed
    )
    if not 0.0 <= fault_rate <= 1.0:
        # Fail BEFORE any engine boot: a config typo must not cost a
        # multi-GB weight load first.
        raise ValueError(
            f"fault_rate={fault_rate} outside [0, 1]"
        )
    engine: InferenceEngine
    if engine_config.backend == "fake":
        from bcg_tpu_torch.engine.fake import FakeEngine

        engine = FakeEngine(
            seed=engine_config.fake_seed,
            policy=getattr(engine_config, "fake_policy", "consensus"),
        )
    elif engine_config.backend == "torch":
        from bcg_tpu_torch.engine.torch_engine import TorchEngine

        engine = TorchEngine(engine_config, device=device)
    else:
        raise ValueError(
            f"Unknown engine backend for the PyTorch port: "
            f"{engine_config.backend!r} (expected 'torch' or 'fake')"
        )
    if fault_rate > 0.0:
        from bcg_tpu_torch.engine.fault import FaultInjectingEngine

        engine = FaultInjectingEngine(engine, fault_rate, fault_seed)
    return engine
