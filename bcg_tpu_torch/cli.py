"""CLI entry point of the PyTorch port (reference ``main.py:998-1070``).

The flags of ``bcg_tpu/cli.py`` that this port serves: the game's shape,
model, seed, network and channel, prefix caching and length buckets,
guided grammar, weight quantization (int8 or int4), the KV-cache dtype
(bfloat16 or int8), fast-forward and speculative decoding, results and
checkpoints, plus ``--device``: the game runs on the CUDA card unless
``--device cpu`` is given.  The other flags come back with the ROADMAP
item that ports what they switch on (parallelism A13, the fake backend
and fault injection A11).  As in the JAX package, the block-paged KV
cache and the packed-int4 KV cache have no flag: they are
``BCG_TPU_PAGED_KV=1`` and ``BCG_TPU_KV_DTYPE=int4`` (or
``EngineConfig.paged_kv`` / ``kv_cache_dtype``).

    python -m bcg_tpu_torch.cli --honest 8 --byzantine 2 --model bcg-tpu/bench-8b
    python -m bcg_tpu_torch.cli --honest 2 --byzantine 1 --model tiny-test --device cpu
    python -m bcg_tpu_torch.cli --honest 2 --byzantine 1 --model tiny-test --device cpu \
        --fast-forward --kv-cache-dtype int8
    python -m bcg_tpu_torch.cli --honest 8 --byzantine 2 --model bcg-tpu/bench-8b \
        --quantization int4
    BCG_TPU_PAGED_KV=1 BCG_TPU_KV_DTYPE=int4 python -m bcg_tpu_torch.cli --honest 2 \
        --byzantine 1 --model bcg-tpu/tiny-dh128 --device cpu --fast-forward
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

from bcg_tpu_torch.config import BCGConfig, resolve_model_name


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Byzantine Consensus Game Simulation (PyTorch port)")
    p.add_argument("--honest", type=int, default=None, help="Number of honest agents")
    p.add_argument("--byzantine", type=int, default=None, help="Number of Byzantine agents (can be 0)")
    p.add_argument("--rounds", type=int, default=None, help="Max number of rounds")
    p.add_argument("--threshold", type=float, default=None, help="Reported majority agreement percentage (default: 66)")
    p.add_argument("--value-range", type=str, default=None, help="Value range as 'min-max' (default: 0-50)")
    p.add_argument(
        "--byzantine-awareness",
        type=str,
        default="may_exist",
        choices=["may_exist", "none_exist"],
        help="Whether honest agents are told Byzantine agents may exist",
    )
    p.add_argument("--verbose", action="store_true", help="Print detailed output to terminal")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Torch device the engine runs on (default: cuda)")
    p.add_argument("--model", type=str, default=None, help="Model preset key or full path")
    p.add_argument("--seed", type=int, default=None, help="Game RNG seed (reproducible runs)")
    p.add_argument("--topology", type=str, default=None, choices=["fully_connected", "ring", "grid"], help="Network topology")
    p.add_argument("--results-dir", type=str, default=None, help="Results directory")
    p.add_argument("--no-save", action="store_true", help="Disable result files")
    p.add_argument("--plots", action="store_true", help="Save per-run plots (value trajectories, agreement)")
    p.add_argument("--checkpoint-every-round", action="store_true", help="Write a resumable checkpoint after each round")
    p.add_argument("--resume", type=str, default=None, help="Resume from checkpoint file")
    p.add_argument("--quantization", type=str, default=None, choices=["int8", "int4"],
                   help="Weight quantization: int8 = dynamic W8A8 (halves the weight "
                        "bytes), int4 = grouped W4A16 (a quarter of bf16's)")
    p.add_argument("--kv-cache-dtype", type=str, default=None, choices=["bfloat16", "int8"],
                   help="KV cache storage dtype (int8 halves decode cache traffic)")
    p.add_argument("--no-prefix-caching", action="store_true",
                   help="Disable system-prompt KV prefix caching")
    p.add_argument("--fine-suffix-buckets", action="store_true",
                   help="Finer suffix-length buckets (1536/3072 rungs): less pad "
                        "traffic in the decode window, more distinct shapes")
    p.add_argument("--fast-forward", action="store_true",
                   help="Forced-chain fast-forward decoding (skeleton tokens ride the sampled token's weight pass)")
    p.add_argument("--spec-decode", action="store_true",
                   help="Prompt-lookup speculative decoding: n-gram drafts from the "
                        "row's own history verified K+1 tokens per weight pass "
                        "(token-identical at temperature 0; supersedes --fast-forward)")
    p.add_argument("--compact-json", action="store_true",
                   help="Compact-JSON generation grammar (no inter-token whitespace)")
    p.add_argument("--shared-core-votes", action="store_true",
                   help="Serve the vote phase's shared proposals/history block from a "
                        "cached KV prefix (restructures vote prompts; opt-in because "
                        "the text diverges from the reference's format)")
    p.add_argument("--protocol", type=str, default=None,
                   choices=["a2a_sim", "lossy_sim"],
                   help="Communication protocol (lossy_sim adds seeded message drops/delays)")
    p.add_argument("--drop-prob", type=float, default=None,
                   help="lossy_sim: per-message drop probability")
    p.add_argument("--delay-prob", type=float, default=None,
                   help="lossy_sim: probability a message arrives 1..max-delay rounds late")
    p.add_argument("--max-delay", type=int, default=None,
                   help="lossy_sim: maximum delivery delay in rounds")
    return p


def config_from_args(args) -> BCGConfig:
    base = BCGConfig()
    game = base.game
    if args.value_range:
        try:
            lo, hi = map(int, args.value_range.split("-"))
        except ValueError:
            raise SystemExit(
                f"Error: Invalid value range format '{args.value_range}'. Use 'min-max' (e.g., 0-50)"
            )
        value_range = (lo, hi)
    else:
        value_range = game.value_range

    game = dataclasses.replace(
        game,
        num_honest=args.honest if args.honest is not None else game.num_honest,
        num_byzantine=args.byzantine if args.byzantine is not None else game.num_byzantine,
        max_rounds=args.rounds if args.rounds is not None else game.max_rounds,
        consensus_threshold=args.threshold if args.threshold is not None else game.consensus_threshold,
        value_range=value_range,
        byzantine_awareness=args.byzantine_awareness,
        seed=args.seed,
    )
    engine = dataclasses.replace(base.engine, backend="torch")
    if args.model:
        engine = dataclasses.replace(engine, model_name=resolve_model_name(args.model))
    if args.quantization:
        engine = dataclasses.replace(engine, quantization=args.quantization)
    if args.kv_cache_dtype:
        engine = dataclasses.replace(engine, kv_cache_dtype=args.kv_cache_dtype)
    if args.no_prefix_caching:
        engine = dataclasses.replace(engine, prefix_caching=False)
    if args.fine_suffix_buckets:
        engine = dataclasses.replace(engine, fine_suffix_buckets=True)
    if args.fast_forward:
        engine = dataclasses.replace(engine, decode_fast_forward=True)
    if args.spec_decode:
        engine = dataclasses.replace(engine, spec_decode=True)
    if args.compact_json:
        engine = dataclasses.replace(engine, guided_compact_json=True)
    network = base.network
    if args.topology:
        network = dataclasses.replace(network, topology_type=args.topology)
    communication = base.communication
    if args.protocol:
        communication = dataclasses.replace(communication, protocol_type=args.protocol)
    channel_knobs = (args.drop_prob, args.delay_prob, args.max_delay)
    if any(k is not None for k in channel_knobs) and \
            communication.protocol_type != "lossy_sim":
        # The reliable channel ignores these — running a "30%-loss"
        # experiment over a perfect channel must fail loudly, not
        # silently produce wrong science.
        raise SystemExit(
            "Error: --drop-prob/--delay-prob/--max-delay require "
            "--protocol lossy_sim"
        )
    if args.drop_prob is not None:
        communication = dataclasses.replace(communication, drop_prob=args.drop_prob)
    if args.delay_prob is not None:
        communication = dataclasses.replace(communication, delay_prob=args.delay_prob)
    if args.max_delay is not None:
        communication = dataclasses.replace(communication, max_delay_rounds=args.max_delay)
    agent = base.agent
    if args.shared_core_votes:
        agent = dataclasses.replace(agent, shared_core_votes=True)
    metrics = base.metrics
    if args.results_dir:
        metrics = dataclasses.replace(metrics, results_dir=args.results_dir)
    if args.no_save:
        metrics = dataclasses.replace(metrics, save_results=False)
    if args.checkpoint_every_round:
        metrics = dataclasses.replace(metrics, checkpoint_every_round=True)
    if args.plots:
        metrics = dataclasses.replace(metrics, generate_plots=True)

    return BCGConfig(
        game=game,
        network=network,
        communication=communication,
        engine=engine,
        agent=agent,
        metrics=metrics,
        verbose=args.verbose,
    )


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    config = config_from_args(args)

    print("=" * 60)
    print("Configuration:")
    print(f"  Honest agents: {config.game.num_honest}")
    print(f"  Byzantine agents: {config.game.num_byzantine}")
    print(f"  Value range: {config.game.value_range[0]}-{config.game.value_range[1]}")
    print(f"  Max rounds: {config.game.max_rounds}")
    print(f"  Consensus threshold: {config.game.consensus_threshold}%")
    print(f"  Byzantine awareness: {config.game.byzantine_awareness}")
    print(f"  Backend: {config.engine.backend} ({config.engine.model_name})")
    print("=" * 60)

    try:
        from bcg_tpu_torch.engine.interface import create_engine

        engine = create_engine(config.engine, device=args.device)
        if args.resume:
            from bcg_tpu_torch.runtime.checkpoint import resume_simulation

            sim = resume_simulation(args.resume, config=config, engine=engine)
        else:
            from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

            sim = BCGSimulation(config=config, engine=engine)
    except (ValueError, FileNotFoundError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    try:
        sim.run()
    finally:
        sim.engine.shutdown()
        sim.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
