"""Host-time A/B of one game round on a dense and a paged engine.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.round_ab

Makes ``bcg-tpu/bench-8b``'s random weights on the card once (seed 0),
then boots two engines over them: the default dense engine (bf16 cache,
plain loop) and a paged one (a bf16 pool of 8192 blocks, as
``chip_smoke.py``'s P5, plain loop).
Each plays the first round of the 8 honest + 2 Byzantine game (seed 0,
greedy) once untimed, which makes its prompt prefixes resident, and then
the same round is timed twice on each engine in turn (dense, paged,
dense, paged), so both are measured at the same
point of one process.  Prints the card's name and power limit and one
JSON line with each round's wall milliseconds and decode steps.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

MODEL = "bcg-tpu/bench-8b"
POOL_BLOCKS = 8192
REPEATS = 2


def game_config(**engine_kw):
    from bcg_tpu_torch.config import (BCGConfig, EngineConfig, GameConfig, LLMConfig,
                                      MetricsConfig)

    return BCGConfig(
        game=GameConfig(num_honest=8, num_byzantine=2, max_rounds=1, seed=0),
        engine=EngineConfig(backend="torch", model_name=MODEL, **engine_kw),
        llm=LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
        metrics=MetricsConfig(save_results=False),
    )


def play(engine, cfg):
    """One round on ``engine``: (wall ms, decode steps)."""
    import torch

    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    sim = BCGSimulation(cfg, engine=engine)
    steps0 = engine.total_decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, engine.total_decode_steps - steps0


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("round_ab: no CUDA device", file=sys.stderr)
        return 2
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = init_params(spec_for_model(MODEL), gen, "cuda")
    cfgs = {"dense": game_config(),
            "paged": game_config(paged_kv=True, kv_pool_blocks=POOL_BLOCKS)}
    engines = {name: TorchEngine(cfg.engine, device="cuda", params=params)
               for name, cfg in cfgs.items()}
    try:
        warm = {name: play(engines[name], cfg) for name, cfg in cfgs.items()}
        rounds = {name: [] for name in cfgs}
        for _ in range(REPEATS):
            for name, cfg in cfgs.items():
                rounds[name].append(play(engines[name], cfg))
    finally:
        for engine in engines.values():
            engine.shutdown()
    print("round_ab: " + json.dumps({
        "model": MODEL, "pool_blocks": POOL_BLOCKS,
        "warmup_round_wall_ms": {n: w[0] for n, w in warm.items()},
        "round_wall_ms": {n: [r[0] for r in rs] for n, rs in rounds.items()},
        "decode_steps": {n: [r[1] for r in rs] for n, rs in rounds.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
