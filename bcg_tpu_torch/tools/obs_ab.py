"""Does the observability layer change a token?  One sampled game played
with each observability flag on, with all of them and with none.

Run from the repository root (on the card if there is one, else the CPU):

    python -m bcg_tpu_torch.tools.obs_ab [--device cpu] [--threads N] [--repeats N]

Makes ``bcg-tpu/tiny-dh128``'s random weights once (``init_params``,
seed 0), then plays the same game (2 honest + 1 Byzantine agents, one
round, game seed 0, the default sampling temperatures and top-p: the
game of ROADMAP C-port-6) on a fresh engine for each flag set, in this
order: none, each of ``BCG_TPU_TRACE``, ``BCG_TPU_HOSTSYNC``,
``BCG_TPU_COMPILE_OBS``, ``BCG_TPU_HLO_CENSUS`` and
``BCG_TPU_GAME_EVENTS`` alone, all of them, none again; each set
``--repeats`` times.  Prints one JSON line a game (the flag set, a digest
of its decisions, votes and statistics, its first round's decisions, its
wall seconds) and, last, a summary: the games played, the digest of the
first flag-free game and every game that differs from it.  Exits 1 if
any game differs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

MODEL = "bcg-tpu/tiny-dh128"
FLAGS = ("BCG_TPU_TRACE", "BCG_TPU_HOSTSYNC", "BCG_TPU_COMPILE_OBS", "BCG_TPU_HLO_CENSUS",
         "BCG_TPU_GAME_EVENTS")


def flag_sets(events_path):
    def env(flags):
        return {f: events_path if f == "BCG_TPU_GAME_EVENTS" else "1" for f in flags}

    sets = [("none", {})] + [(f, env((f,))) for f in FLAGS]
    return sets + [("all", env(FLAGS)), ("none", {})]


def obs_reset():
    """Make the observability modules read the environment again (each
    reads its flags once)."""
    from bcg_tpu_torch.obs import compile as obs_compile, game_events, hlo, hostsync, tracer

    for fn in (tracer.reset, hostsync.reset, obs_compile.reset, hlo.reset,
               game_events.reset_sink):
        fn()


def play(cfg, params, device):
    """One game on a fresh engine: (decisions, votes, statistics)."""
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    engine = TorchEngine(cfg.engine, device=device, params=params)
    sim = BCGSimulation(cfg, engine=engine)
    votes, close = [], sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    engine.shutdown()
    return [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds], votes, stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda or cpu (default: cuda when a card is present)")
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--threads", type=int, default=0,
                        help="torch intra-op threads (default: torch's own)")
    args = parser.parse_args()
    import torch

    from bcg_tpu_torch.config import (BCGConfig, EngineConfig, GameConfig, LLMConfig,
                                      MetricsConfig)
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params

    device = args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    if args.threads:
        torch.set_num_threads(args.threads)
    if device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(spec_for_model(MODEL), gen, device)
    cfg = BCGConfig(
        game=GameConfig(num_honest=2, num_byzantine=1, max_rounds=1, seed=0),
        engine=EngineConfig(backend="torch", model_name=MODEL),
        llm=LLMConfig(),
        metrics=MetricsConfig(save_results=False),
    )
    reference, differ, played = None, [], 0
    with tempfile.TemporaryDirectory() as tmp:
        for name, env in flag_sets(os.path.join(tmp, "events.jsonl")):
            for rep in range(args.repeats):
                for flag in FLAGS:
                    os.environ.pop(flag, None)
                os.environ.update(env)
                obs_reset()
                t0 = time.perf_counter()
                decisions, votes, stats = play(cfg, params, device)
                wall = time.perf_counter() - t0
                digest = hashlib.sha1(json.dumps([decisions, votes, stats], sort_keys=True,
                                                 default=str).encode()).hexdigest()[:16]
                reference = reference or digest
                played += 1
                if digest != reference:
                    differ.append({"flags": name, "repeat": rep, "digest": digest})
                print(json.dumps({"flags": name, "repeat": rep, "digest": digest,
                                  "decisions": decisions[0][1], "seconds": round(wall, 3)}),
                      flush=True)
        for flag in FLAGS:
            os.environ.pop(flag, None)
        obs_reset()
    print(json.dumps({"model": MODEL, "device": device,
                      "threads": torch.get_num_threads(), "games": played,
                      "reference": reference, "differ": differ}), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
