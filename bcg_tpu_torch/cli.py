"""CLI entry point of the PyTorch port (reference ``main.py:998-1070``).

The flags of ``bcg_tpu/cli.py`` that this port serves: the game's shape,
model, seed, network and channel, prefix caching and length buckets,
guided grammar, weight quantization (int8 or int4), the KV-cache dtype
(bfloat16 or int8), fast-forward and speculative decoding, results and
checkpoints, the backend (``torch`` or the deterministic ``fake``), the
serving scheduler (``--serve``), fake policies and fault injection, plus
``--device``: the game runs on the CUDA card unless ``--device cpu`` is
given, and ``--profile-dir`` (a ``torch.profiler`` trace of the run).
The mesh flags (``--tensor-parallel``, ``--sequence-parallel``,
``--data-parallel``) run one process a device under ``torchrun``, every
rank playing the same game (rank 0 writes the results);
``--spmd-exchange`` exchanges values with one all-gather over the mesh's
``dp`` ranks.  As in the JAX package, the block-paged KV
cache and the packed-int4 KV cache have no flag: they are
``BCG_TPU_PAGED_KV=1`` and ``BCG_TPU_KV_DTYPE=int4`` (or
``EngineConfig.paged_kv`` / ``kv_cache_dtype``).

    python -m bcg_tpu_torch.cli --honest 8 --byzantine 2 --model bcg-tpu/bench-8b
    python -m bcg_tpu_torch.cli --honest 2 --byzantine 1 --model tiny-test --device cpu
    python -m bcg_tpu_torch.cli --honest 4 --byzantine 0 --backend fake --seed 0 --serve --verbose
    python -m bcg_tpu_torch.cli --honest 2 --byzantine 1 --model tiny-test --device cpu \
        --fast-forward --kv-cache-dtype int8
    python -m bcg_tpu_torch.cli --honest 8 --byzantine 2 --model bcg-tpu/bench-8b \
        --quantization int4
    BCG_TPU_PAGED_KV=1 BCG_TPU_KV_DTYPE=int4 python -m bcg_tpu_torch.cli --honest 2 \
        --byzantine 1 --model bcg-tpu/tiny-dh128 --device cpu --fast-forward
    torchrun --nproc-per-node 2 -m bcg_tpu_torch.cli --honest 2 --byzantine 1 \
        --model tiny-test --device cpu --tensor-parallel 2 --no-save
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
    p.add_argument("--backend", type=str, default=None, choices=["torch", "fake"],
                   help="Inference backend (default: torch)")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="Torch device the engine runs on (default: cuda)")
    p.add_argument("--model", type=str, default=None, help="Model preset key or full path")
    p.add_argument("--seed", type=int, default=None, help="Game RNG seed (reproducible runs)")
    p.add_argument("--topology", type=str, default=None, choices=["fully_connected", "ring", "grid"], help="Network topology")
    p.add_argument("--spmd-exchange", action="store_true",
                   help="Exchange values via one all_gather over the mesh's dp ranks "
                        "instead of the host message loop")
    p.add_argument("--serve", action="store_true",
                   help="Route LLM calls through the continuous-batching "
                        "serving scheduler (bcg_tpu_torch/serve; also enabled by "
                        "BCG_TPU_SERVE=1) — prints scheduler stats on exit "
                        "with --verbose")
    p.add_argument("--results-dir", type=str, default=None, help="Results directory")
    p.add_argument("--no-save", action="store_true", help="Disable result files")
    p.add_argument("--plots", action="store_true", help="Save per-run plots (value trajectories, agreement)")
    p.add_argument("--checkpoint-every-round", action="store_true", help="Write a resumable checkpoint after each round")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="Write a torch.profiler trace of the run to this directory (trace.json)")
    p.add_argument("--resume", type=str, default=None, help="Resume from checkpoint file")
    p.add_argument("--tensor-parallel", type=int, default=None,
                   help="TP mesh axis size (heads, MLP and vocabulary split over ranks)")
    p.add_argument("--sequence-parallel", type=int, default=None,
                   help="SP mesh axis size (the KV sequence split over ranks; "
                        "ring-attention prefill)")
    p.add_argument("--data-parallel", type=int, default=None,
                   help="DP mesh axis size (agent parallelism: each rank decodes its "
                        "share of a game batch's rows)")
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
    p.add_argument("--fake-policy", type=str, default=None,
                   help="Fake-backend scripted policy: consensus|schema_min|"
                        "stubborn|median|disrupt|oscillate|mimic|silent, or "
                        "mixed:<honest>:<byzantine> for a role-aware mix")
    p.add_argument("--fault-rate", type=float, default=None,
                   help="Corrupt this fraction of LLM responses (resilience experiments)")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="Seed for fault injection")
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
    engine = base.engine
    if args.backend:
        engine = dataclasses.replace(engine, backend=args.backend)
    if args.model:
        engine = dataclasses.replace(engine, model_name=resolve_model_name(args.model))
    if args.tensor_parallel:
        engine = dataclasses.replace(engine, tensor_parallel_size=args.tensor_parallel)
    if args.sequence_parallel:
        engine = dataclasses.replace(engine, sequence_parallel_size=args.sequence_parallel)
    if args.data_parallel:
        engine = dataclasses.replace(engine, data_parallel_size=args.data_parallel)
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
    if args.fault_rate is not None:
        engine = dataclasses.replace(engine, fault_rate=args.fault_rate)
    if args.fake_policy is not None:
        engine = dataclasses.replace(engine, fake_policy=args.fake_policy)
    if args.fault_seed is not None:
        engine = dataclasses.replace(engine, fault_seed=args.fault_seed)
    network = base.network
    if args.topology:
        network = dataclasses.replace(network, topology_type=args.topology)
    if args.spmd_exchange:
        network = dataclasses.replace(network, spmd_exchange=True)
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

    device = args.device
    if any(n > 1 for n in (args.tensor_parallel or 1, args.sequence_parallel or 1,
                           args.data_parallel or 1)):
        # One rank a device: the world comes from torchrun's environment.
        from bcg_tpu_torch.parallel import distributed

        try:
            distributed.initialize(device_type=args.device)
        except RuntimeError as e:   # --device cuda (the default) on a host without a card
            print(f"Error: {e}", file=sys.stderr)
            return 1
        device = distributed.device()
    try:
        from bcg_tpu_torch.engine.interface import create_engine

        engine = create_engine(config.engine, device=device)
        if args.resume:
            from bcg_tpu_torch.runtime.checkpoint import resume_simulation

            sim = resume_simulation(args.resume, config=config, engine=engine)
        else:
            from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

            sim = BCGSimulation(config=config, engine=engine)
    except (ValueError, FileNotFoundError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    serving = None
    from bcg_tpu_torch.runtime import envflags

    if args.serve or envflags.get_bool("BCG_TPU_SERVE"):
        from bcg_tpu_torch.serve import ServingEngine, mesh as mesh_serving

        def factory():
            return create_engine(config.engine, device=device)

        if mesh_serving.spans_world(sim.engine) and not mesh_serving.is_leader():
            # Under torchrun the game plays on rank 0, whose scheduler
            # leads; this rank makes each of its dispatches' engine calls.
            try:
                mesh_serving.follow(sim.engine, factory)
            finally:
                sim.engine.shutdown()
                sim.close()
            return 0
        # Front the engine with the continuous-batching scheduler; it
        # owns the inner engine so one shutdown() releases both.  The
        # factory lets the supervisor reboot a hung engine from the
        # same config, on the same device (BCG_TPU_SERVE_WATCHDOG_S).
        serving = ServingEngine(sim.engine, owns_inner=True, engine_factory=factory)
        sim.set_engine(serving)
    try:
        from bcg_tpu_torch.runtime.profiler import torch_trace

        with torch_trace(args.profile_dir):
            sim.run()
        if serving is not None and config.verbose:
            import json as _json

            print("[Serving Scheduler]")
            print(_json.dumps(serving.stats(), indent=2))
    finally:
        sim.engine.shutdown()
        sim.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
