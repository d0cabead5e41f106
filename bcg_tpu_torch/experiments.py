"""Paper-experiment presets of the PyTorch port (reference
README.md:55-70).

The reference documents its Q1/Q2 experiments as raw CLI invocations;
this module makes them first-class, repeatable presets with multi-run
aggregation — plus the BASELINE.json sweep configs the reference never
scripted:

    python -m bcg_tpu_torch.experiments q1-baseline --backend fake --runs 5
    python -m bcg_tpu_torch.experiments q2 --model bcg-tpu/bench-8b --runs 4 --concurrency 4
    python -m bcg_tpu_torch.experiments q1-baseline --model tiny-test --device cpu --rounds 1 \
        --runs 2 --concurrency 2
    python -m bcg_tpu_torch.experiments scale-sweep --agents 16,32,64

Each run goes through :func:`bcg_tpu_torch.api.run_simulation` (no files
written); the aggregate summary (consensus rate, mean rounds, Q2 quality
scores) prints as JSON so sweeps are scriptable.  The engine runs on the
CUDA card unless ``device="cpu"`` (``--device cpu``) is given.
"""

from __future__ import annotations

import argparse
import json
import statistics
from dataclasses import dataclass
from typing import Dict, List, Optional

from bcg_tpu_torch.api import run_simulation


@dataclass(frozen=True)
class Preset:
    name: str
    description: str
    honest: int
    byzantine: int
    awareness: str
    max_rounds: int = 50


# Reference README.md:57-70 ("Reproducing Paper Experiments") plus the
# driver's BASELINE.json configs.
PRESETS: Dict[str, Preset] = {
    "q1-baseline": Preset(
        "q1-baseline",
        "Q1 cooperative: 4 honest, none_exist prompt (CPU-runnable smoke)",
        honest=4, byzantine=0, awareness="none_exist",
    ),
    "q1-full": Preset(
        "q1-full",
        "Q1 cooperative: 8 honest, may_exist prompt",
        honest=8, byzantine=0, awareness="may_exist",
    ),
    "q2": Preset(
        "q2",
        "Q2 resilience: 8 honest + 2 Byzantine, may_exist prompt",
        honest=8, byzantine=2, awareness="may_exist",
    ),
}


def _mean(xs: List[float]) -> Optional[float]:
    xs = [x for x in xs if x is not None]
    return round(statistics.mean(xs), 4) if xs else None


def aggregate(metrics: List[Dict]) -> Dict:
    """Cross-run summary over per-run ``get_statistics()`` payloads —
    the distribution-level view SURVEY.md §7 calls for (the reference is
    unseeded + temperature-sampled, so parity lives in aggregates, not
    transcripts)."""
    return {
        "runs": len(metrics),
        "consensus_rate": _mean([float(m.get("consensus_reached", False)) for m in metrics]),
        "mean_rounds": _mean([m.get("total_rounds") for m in metrics]),
        "mean_convergence_speed": _mean([m.get("convergence_speed") for m in metrics]),
        "mean_quality_score": _mean([m.get("consensus_quality_score") for m in metrics]),
        "mean_centrality": _mean([m.get("centrality") for m in metrics]),
        "byzantine_infiltration_rate": _mean(
            [float(m["byzantine_infiltration"])
             for m in metrics if m.get("byzantine_infiltration") is not None]
        ),
        "outcomes": sorted(
            {str(m.get("consensus_outcome")) for m in metrics}
        ),
    }


def run_preset(
    preset: Preset,
    runs: int = 1,
    model_name: Optional[str] = None,
    backend: Optional[str] = None,
    max_rounds: Optional[int] = None,
    seed: Optional[int] = 0,
    honest: Optional[int] = None,
    byzantine: Optional[int] = None,
    concurrency: int = 1,
    fault_rate: float = 0.0,
    drop_prob: float = 0.0,
    fake_policy: Optional[str] = None,
    device: Optional[str] = None,
) -> Dict:
    """Run a preset ``runs`` times and aggregate.

    ``concurrency > 1`` runs that many games at once against ONE shared
    engine, merged into single device batches per phase
    (engine/collective.py) — decode cost is per-step weight streaming, so
    G concurrent games cost roughly one game's wall-clock.  The reference
    has no equivalent: its sweeps are sequential CLI invocations
    (README.md:55-70).

    ``fault_rate`` corrupts that fraction of LLM responses per run
    (engine/fault.py); ``drop_prob`` routes the games over the lossy
    channel (comm/lossy_sim.py) with that per-message drop probability —
    together they make resilience-vs-fault curves (LLM-side and
    channel-side) one-flag sweeps.  ``device`` is the torch device of
    the engine (``None`` means CUDA).
    """
    import dataclasses

    from bcg_tpu_torch.api import resolve_engine_config
    from bcg_tpu_torch.config import BCGConfig, CommunicationConfig

    n_honest = honest if honest is not None else preset.honest
    n_byz = byzantine if byzantine is not None else preset.byzantine
    engine_cfg = dataclasses.replace(
        resolve_engine_config(model_name, backend), fault_rate=fault_rate
    )
    if fake_policy is not None:
        engine_cfg = dataclasses.replace(engine_cfg, fake_policy=fake_policy)
    base_cfg = dataclasses.replace(BCGConfig(), engine=engine_cfg)
    if drop_prob:
        # Fail BEFORE any engine boot (same invariant as fault_rate,
        # engine/interface.py): a config typo must not cost a multi-GB
        # weight load first.
        if not 0.0 <= drop_prob <= 1.0:
            raise ValueError(f"drop_prob={drop_prob}: expected [0, 1]")
        base_cfg = dataclasses.replace(
            base_cfg,
            communication=CommunicationConfig(
                protocol_type="lossy_sim", drop_prob=drop_prob
            ),
        )

    def make_run(r: int):
        def go(engine=None):
            return run_simulation(
                n_agents=n_honest + n_byz,
                byzantine_count=n_byz,
                max_rounds=max_rounds if max_rounds is not None else preset.max_rounds,
                byzantine_awareness=preset.awareness,
                model_name=model_name,
                backend=backend,
                seed=None if seed is None else seed + r,
                engine=engine,
                config=base_cfg,
                device=device,
            )
        return go

    if concurrency > 1:
        from bcg_tpu_torch.engine.interface import create_engine
        from bcg_tpu_torch.runtime import envflags

        engine = create_engine(engine_cfg, device=device)
        try:
            if envflags.get_bool("BCG_TPU_SERVE"):
                # Arrival-driven serving scheduler (bcg_tpu/serve): no
                # lockstep waves — all runs start, at most `concurrency`
                # execute at once, and a straggler delays only itself.
                from bcg_tpu_torch.serve import run_serving_simulations

                outs = run_serving_simulations(
                    engine, [make_run(r) for r in range(runs)],
                    max_concurrent=concurrency,
                    # Supervisor rebuild hook: a hang past the (env-
                    # gated) watchdog reboots the engine from the same
                    # config instead of killing the whole sweep.
                    engine_factory=lambda: create_engine(engine_cfg, device=device),
                )
            else:
                from bcg_tpu_torch.engine.collective import run_concurrent_simulations

                outs = run_concurrent_simulations(
                    engine, [make_run(r) for r in range(runs)], concurrency
                )
        finally:
            engine.shutdown()
        failures = [o for o in outs if isinstance(o, BaseException)]
        if failures:
            raise failures[0]
        per_run = [o["metrics"] for o in outs]
    else:
        per_run = [make_run(r)()["metrics"] for r in range(runs)]
    return {"preset": preset.name, "aggregate": aggregate(per_run), "per_run": per_run}


def run_scale_sweep(
    agent_counts: List[int],
    byzantine_fraction: float = 0.0,
    **kwargs,
) -> List[Dict]:
    """BASELINE.json config 4: growing agent populations (one-agent-per-
    chip on real pods via the SPMD game step; batched on one chip here)."""
    results = []
    for n in agent_counts:
        byz = int(n * byzantine_fraction)
        p = Preset(f"scale-{n}", f"{n - byz}H+{byz}B", honest=n - byz,
                   byzantine=byz, awareness="may_exist")
        results.append(run_preset(p, **kwargs))
    return results


def run_model_sweep(models: List[str], **kwargs) -> List[Dict]:
    """BASELINE.json config 5: the Q2 mixed honest/Byzantine population
    swept across model families (each model boots its own engine; the
    reference would re-run its CLI per `MODEL_PRESETS` entry,
    config.py:20-30)."""
    results = []
    for m in models:
        r = run_preset(PRESETS["q2"], model_name=m, **kwargs)
        r["preset"] = f"model-sweep:{m}"
        results.append(r)
    return results


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="BCG paper-experiment presets")
    p.add_argument("preset", choices=[*PRESETS, "scale-sweep", "model-sweep"])
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--backend", type=str, default=None, choices=["torch", "fake"])
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Torch device the engine runs on (default: cuda)")
    p.add_argument("--rounds", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--agents", type=str, default="16,32,64",
                   help="scale-sweep agent counts, comma-separated")
    p.add_argument("--models", type=str,
                   default="Qwen/Qwen3-32B,mistralai/Mistral-Small-Instruct-2409",
                   help="model-sweep model names, comma-separated "
                        "(BASELINE.json config 5)")
    p.add_argument("--byzantine-fraction", type=float, default=0.0,
                   help="scale-sweep Byzantine share of each population")
    p.add_argument("--concurrency", type=int, default=1,
                   help="Games run at once against one shared engine "
                        "(merged device batches; bound by KV-cache memory)")
    p.add_argument("--fault-rate", type=float, default=0.0,
                   help="Corrupt this fraction of LLM responses per run "
                        "(resilience-vs-fault-rate sweeps)")
    p.add_argument("--drop-prob", type=float, default=0.0,
                   help="Route games over the lossy channel with this "
                        "per-message drop probability "
                        "(resilience-vs-loss sweeps)")
    p.add_argument("--fake-policy", type=str, default=None,
                   help="Fake-backend scripted policy, e.g. "
                        "mixed:consensus:oscillate (adversary-strategy "
                        "sweeps without any LLM; engine/fake.py)")
    args = p.parse_args(argv)

    sweep_models = (
        args.models.split(",") if args.preset == "model-sweep" else []
    )
    for name in [args.model, *sweep_models]:
        if name and name.startswith("bcg-hf/"):
            # Hermetic HF fixtures materialize on demand (idempotent) — a
            # parity sweep must not depend on an earlier run having built
            # the checkpoint.
            from bcg_tpu_torch.models.hf_fixture import build_checkpoint

            build_checkpoint(name)

    common = dict(runs=args.runs, model_name=args.model, backend=args.backend,
                  max_rounds=args.rounds, seed=args.seed,
                  concurrency=args.concurrency, fault_rate=args.fault_rate,
                  drop_prob=args.drop_prob, fake_policy=args.fake_policy,
                  device=args.device)
    if args.preset == "scale-sweep":
        out = run_scale_sweep(
            [int(x) for x in args.agents.split(",")],
            byzantine_fraction=args.byzantine_fraction, **common,
        )
        print(json.dumps([{k: r[k] for k in ("preset", "aggregate")} for r in out], indent=2))
    elif args.preset == "model-sweep":
        if common.pop("model_name"):
            p.error("model-sweep takes --models (a comma-separated list), "
                    "not --model")
        models = [m.strip() for m in args.models.split(",") if m.strip()]
        out = run_model_sweep(models, **common)
        print(json.dumps([{k: r[k] for k in ("preset", "aggregate")} for r in out], indent=2))
    else:
        out = run_preset(PRESETS[args.preset], **common)
        print(json.dumps({"preset": out["preset"], "aggregate": out["aggregate"]}, indent=2))


if __name__ == "__main__":
    main()
