"""Programmatic batch-experiment API of the PyTorch port (reference
``main.py:1073-1141``).

``run_simulation`` runs one game with file-saving disabled and returns
``{"metrics": stats}``.  Unlike the reference, which temporarily mutates
METRICS_CONFIG/VLLM_CONFIG globals with a finally-restore dance
(main.py:1094-1102), each call here builds its own immutable config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from bcg_tpu_torch.config import BCGConfig, EngineConfig, resolve_model_name
from bcg_tpu_torch.engine.interface import InferenceEngine


def resolve_engine_config(
    model_name: Optional[str],
    backend: Optional[str],
    base: Optional[BCGConfig] = None,
) -> EngineConfig:
    """The single place name/backend overrides become an EngineConfig —
    shared by per-run construction here and the concurrent-sweep shared
    engine in :mod:`bcg_tpu_torch.experiments`, so both always agree."""
    engine_cfg = (base or BCGConfig()).engine
    if model_name:
        engine_cfg = dataclasses.replace(
            engine_cfg, model_name=resolve_model_name(model_name)
        )
    if backend:
        engine_cfg = dataclasses.replace(engine_cfg, backend=backend)
    return engine_cfg


def run_simulation(
    n_agents: int = 8,
    max_rounds: int = 50,
    model_name: Optional[str] = None,
    byzantine_count: int = 0,
    byzantine_awareness: str = "may_exist",
    backend: Optional[str] = None,
    seed: Optional[int] = None,
    engine: Optional[InferenceEngine] = None,
    config: Optional[BCGConfig] = None,
    device: Optional[str] = None,
) -> dict:
    """Run a single simulation for batch experiments; no files written.
    ``device`` is the torch device of an internally created engine
    (``None`` means CUDA)."""
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    base = config or BCGConfig()
    game = dataclasses.replace(
        base.game,
        num_honest=n_agents - byzantine_count,
        num_byzantine=byzantine_count,
        max_rounds=max_rounds,
        byzantine_awareness=byzantine_awareness,
        seed=seed if seed is not None else base.game.seed,
    )
    engine_cfg = resolve_engine_config(model_name, backend, base=base)
    metrics = dataclasses.replace(base.metrics, save_results=False, generate_plots=False)

    created = engine is None
    run_engine = engine
    if created:
        from bcg_tpu_torch.engine.interface import create_engine

        run_engine = create_engine(engine_cfg, device=device)

    try:
        sim = BCGSimulation(
            config=dataclasses.replace(base, game=game, engine=engine_cfg, metrics=metrics),
            engine=run_engine,
        )
    except BaseException:
        if created and run_engine is not None:
            # The engine exists before the sim does — a constructor
            # failure must not leak device memory.
            run_engine.shutdown()
        raise
    try:
        while not sim.game.game_over:
            sim.run_round()
        stats = sim.game.get_statistics()
        stats["byzantine_awareness"] = byzantine_awareness
        return {"metrics": stats}
    finally:
        if created:
            # We created the engine internally; release its device
            # memory.
            sim.engine.shutdown()
        sim.close()
