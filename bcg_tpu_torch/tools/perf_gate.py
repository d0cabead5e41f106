"""The port's hermetic perf gate: counter-derived metrics against banded
baselines, on the CPU.

    python -m bcg_tpu_torch.tools.perf_gate [--scenarios a,b]
        [--inject-regression X] [--update-baseline] [--json]

The counterpart of ``scripts/perf_gate.py`` over the port's modules.
Each scenario keeps the JAX scenario's model (``bcg-tpu/tiny-test``),
prompts, schemas, seeds, traffic and metric names, so the two baselines
compare name by name; every engine it builds asks for ``device="cpu"``.
The scenarios run the copied fake engine, the serving scheduler, the
sweep controller, the chaos tier, the observability modules, the
``TorchEngine`` and its fused round and the game orchestrator.

Where the port measures a metric another way, the scenario says so:

* the PyTorch engine runs eagerly and counts no trace-cache miss
  (``engine.retrace.*``); what a new shape costs it is noted at its shape
  seams (``pad_batch``, ``split_workspace``, ``sampler_plan``,
  ``nvcc_<library>``, ``megaround_prefix``, ``megaround``) by the compile
  observer (``obs/compile.py``).  The engine, megaround and compile
  scenarios turn the observer on and read its signature events as the
  port's compiles and retraces;
* the port has one sampler kernel and one paged kernel, each with a
  plain version that CPU tensors run.  The sampler scenario holds the
  engine's fused sampler to the plain reference sampler
  (``engine/speculative.make_masked_sampler``) swapped into a second
  engine's decode loops, and counts the wrapper's calls;
* ``hlo`` runs :mod:`bcg_tpu_torch.tools.census_gate` in a subprocess.

The fleet scenario and its ``straggler-off`` injection are not here: its
worker joins a two-process cluster, which needs the port's
``parallel/distributed.py`` (ROADMAP A13).

Exit status: 0 green, 2 findings (a metric outside its band, a measured
metric with no entry, a stale entry), 1 usage.  The baseline is
``bcg_tpu_torch/tools/perf_baseline.json`` (:mod:`.gate_baseline`);
``--update-baseline`` rewrites its values and keeps each entry's band
and reason.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

from bcg_tpu_torch.tools import gate_baseline

# "alerts" stays LAST: its oracle arm resets the counter registry to
# kill absolute-gauge leftovers that earlier scenarios leave behind.
SCENARIOS = ("serve", "engine", "paged", "sampler", "int4", "consensus",
             "hostsync", "megaround", "compile", "sweep", "chaos",
             "scenarios", "hlo", "alerts")
REGRESSIONS = ("none", "spec-off", "fail-rows", "events-off",
               "hostsync-off", "compile-off", "fairness-off", "chaos-off",
               "scenarios-off", "alerts-off")

MODEL = "bcg-tpu/tiny-test"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DECISION = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 25},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
        "public_reasoning": {"type": "string", "minLength": 1, "maxLength": 25},
    },
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False,
}
VOTE = {
    "type": "object",
    "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
    "required": ["decision"],
    "additionalProperties": False,
}
# The engine, hostsync and compile scenarios' benchmark (3 decisions).
BENCH_PROMPTS = [
    ("honest agent system prompt", "Round 3: propose a value", DECISION),
    ("byzantine agent system prompt", "Round 3: vote now", VOTE),
    ("honest agent system prompt", "Round 4: propose a value", DECISION),
]
# The serve, chaos and alerts scenarios' request payload (2 rows).
SERVE_PAYLOAD = [
    ("agent system prompt",
     "Round 2. agent_1 value: 17. agent_2 value: 17. "
     "Your current value: 17. Decide.",
     DECISION),
] * 2


def _engine(**kw):
    """A tiny ``TorchEngine`` on the CPU."""
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    return TorchEngine(EngineConfig(backend="torch", model_name=MODEL,
                                    max_model_len=2048, **kw), device="cpu")


def _bad_rows(rows) -> int:
    return sum(1 for r in rows if not isinstance(r, dict) or "error" in r)


@contextlib.contextmanager
def env_vars(**values):
    """Set (a string) or unset (None) environment variables, restoring
    each raw prior value (set or not) on exit."""
    prior = {name: os.environ.get(name) for name in values}
    try:
        for name, value in values.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        yield
    finally:
        for name, value in prior.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


@contextlib.contextmanager
def _compile_observer(on: bool = True):
    """The compile observer on (or off) for the block, read fresh from
    the flag on entry and dropped on exit."""
    from bcg_tpu_torch.obs import compile as obs_compile

    with env_vars(BCG_TPU_COMPILE_OBS="1" if on else None):
        obs_compile.reset()
        try:
            yield obs_compile
        finally:
            obs_compile.reset()


def _signature_events(obs_compile) -> int:
    """Shape signatures the compile observer has noted (first compiles and
    retraces; 0 with the observer off)."""
    observer = obs_compile.observer()
    return observer.brief()["cache_entries"] if observer is not None else 0


def load_report(name: str):
    """Load ``scripts/<name>.py`` (stdlib-only) by path, as the JAX gate
    does."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _serve_requests(sched, waves: int = 2, threads: int = 8):
    """``waves`` x ``threads`` concurrent 2-row guided requests; returns
    (rows, error rows, errors raised)."""
    rows = error_rows = 0
    errors: List[BaseException] = []
    for _wave in range(waves):
        with ThreadPoolExecutor(max_workers=threads) as pool:
            futures = [pool.submit(sched.submit_and_wait, ("json",), list(SERVE_PAYLOAD),
                                   [0.0] * 2, [64] * 2) for _ in range(threads)]
        for future in futures:
            if future.exception() is not None:  # the caller raises or counts it
                errors.append(future.exception())
                continue
            out = future.result()
            rows += len(out)
            error_rows += _bad_rows(out)
    return rows, error_rows, errors


# ------------------------------------------------------------- scenarios
def run_serve_scenario(inject: str = "none") -> Dict[str, float]:
    """Scripted fake-engine serving run: 2 waves x 8 threads x 2-row
    guided requests against a 16-row bucket with a generous linger, so
    full-bucket merges dominate; the spec mirror (``BCG_TPU_SPEC=1``) gives
    the run a draft-acceptance profile."""
    from bcg_tpu_torch.engine.fake import FakeEngine
    from bcg_tpu_torch.obs import counters as obs_counters
    from bcg_tpu_torch.serve.scheduler import Scheduler

    with env_vars(BCG_TPU_SPEC="0" if inject == "spec-off" else "1"):
        engine = FakeEngine(seed=0, policy="consensus",
                            fail_first_n_calls=(10**6 if inject == "fail-rows" else 0))
        sched = Scheduler(engine, linger_ms=400, bucket_rows=16, max_queue_rows=4096,
                          deadline_ms=0, strict_admission=False)
        before = obs_counters.snapshot()
        rows, error_rows, errors = _serve_requests(sched)
        snap = sched.snapshot()
        sched.close()
        moved = obs_counters.delta(before)
    if errors:
        raise errors[0]
    drafted = moved.get("engine.spec.drafted", 0)
    accepted = moved.get("engine.spec.accepted", 0)
    return {
        "serve.completed_fraction": snap["completed"] / max(1, snap["submitted"]),
        "serve.engine_errors": snap["engine_errors"],
        "serve.error_row_fraction": error_rows / max(1, rows),
        "serve.rows_per_dispatch": snap["dispatched_rows"] / max(1, snap["dispatches"]),
        "serve.spec_acceptance_rate": accepted / drafted if drafted else 0.0,
    }


def run_engine_scenario(inject: str = "none") -> Dict[str, float]:
    """The tiny engine's decision benchmark, plain against speculative, at
    temperature 0; the steady state is a warm repeat call that may note no
    new shape signature (the compile observer on)."""
    from bcg_tpu_torch.obs import counters as obs_counters

    with _compile_observer() as obs_compile:
        std = _engine()
        spec = _engine(spec_decode=(inject != "spec-off"))
        try:
            r_std = std.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=80)
            steps_std = std.total_decode_steps
            before = obs_counters.snapshot()
            r_spec = spec.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=80)
            steps_spec = spec.total_decode_steps
            moved = obs_counters.delta(before)
            seen = _signature_events(obs_compile)
            spec.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=80)
            retraces = _signature_events(obs_compile) - seen
        finally:
            std.shutdown()
            spec.shutdown()
    drafted = moved.get("engine.spec.drafted", 0)
    accepted = moved.get("engine.spec.accepted", 0)
    return {
        "engine.decode_steps_per_decision": steps_spec / len(BENCH_PROMPTS),
        "engine.spec_step_reduction": 1.0 - steps_spec / max(1, steps_std),
        "engine.spec_acceptance_rate": accepted / drafted if drafted else 0.0,
        "engine.steady_state_retraces": float(retraces),
        "engine.error_rows": _bad_rows(r_std + r_spec),
    }


def run_paged_scenario(inject: str = "none") -> Dict[str, float]:
    """Block-paged KV cache gates: per-agent real prefill positions at N=8
    over N=2 under a shared system prompt (and strictly decreasing over N
    in {2, 4, 8}); the radix hit rate after a second round; paged against
    dense greedy outputs, with the default and with the ``pallas``
    implementation (on the CPU both run the paged kernel's plain
    version); the serve admission cap of a paged engine over the dense
    provisioner at one synthetic device-memory budget."""
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.obs import counters as obs_counters
    from bcg_tpu_torch.serve.scheduler import derive_row_cap

    shared_sys = (
        "You are an agent in a Byzantine consensus game. The rules are "
        "long and shared by every participant: propose integer values, "
        "exchange them with peers, and vote to stop once values converge "
        "within the consensus threshold. " * 3
    )
    per_agent: Dict[int, float] = {}
    for n_agents in (2, 4, 8):
        eng = _engine(paged_kv=True)
        before = obs_counters.value("engine.prefill.positions_real")
        eng.batch_generate_json(
            [(shared_sys, f"You are agent_{i}. Round 1. Peers said 17. Decide.", VOTE)
             for i in range(n_agents)],
            temperature=0.0, max_tokens=24,
        )
        per_agent[n_agents] = (
            obs_counters.value("engine.prefill.positions_real") - before) / n_agents
        eng.shutdown()
    monotone = float(per_agent[2] > per_agent[4] > per_agent[8])

    prompts = [(shared_sys + f" You are agent_{i}.", "Round 1. Decide.", DECISION)
               for i in range(3)]
    dense, paged = _engine(), _engine(paged_kv=True)
    try:
        mismatches = 0
        round1_batch = round1_dense = None
        for round_no in (1, 2):
            batch = [(s, f"Round {round_no}. Peers said 17. Decide.", sch)
                     for s, _, sch in prompts]
            r_d = dense.batch_generate_json(batch, temperature=0.0, max_tokens=48)
            r_p = paged.batch_generate_json(batch, temperature=0.0, max_tokens=48)
            mismatches += sum(1 for a, b in zip(r_d, r_p) if a != b)
            if round_no == 1:
                round1_batch, round1_dense = batch, r_d
        hit_rate = (paged.kv_pool_stats() or {}).get("prefix_hit_rate") or 0.0
    finally:
        dense.shutdown()
        paged.shutdown()

    kernel = _engine(paged_kv=True, paged_kv_impl="pallas")
    try:
        r_k = kernel.batch_generate_json(round1_batch, temperature=0.0, max_tokens=48)
    finally:
        kernel.shutdown()
    kernel_mismatches = sum(1 for a, b in zip(round1_dense, r_k) if a != b)

    # Admission gain at one synthetic budget: the dense reserve is the
    # boot formula's fraction without its floor; the pool gets the same
    # budget with no separate reserve.
    limit = 32 << 20
    dense = _engine()
    dense._mem_limit = limit
    free = dense.config.hbm_utilization * limit - dense._param_bytes
    dense._prefix_budget = max(0, int(free * 0.25))
    dense_cap = derive_row_cap(dense) or 1
    block_bytes = EngineConfig().kv_block_size * dense._kv_slot_bytes * dense.spec.num_layers
    usable = max(64, int(free // block_bytes))
    dense.shutdown()
    paged = _engine(paged_kv=True, kv_pool_blocks=usable + 1)
    paged_cap = derive_row_cap(paged) or 1
    paged.shutdown()

    if inject == "fail-rows":
        mismatches += 1  # self-test hook: provoke the parity gate
    return {
        "paged.positions_real_per_agent_slope": per_agent[8] / per_agent[2],
        "paged.positions_real_monotone": monotone,
        "paged.prefix_hit_rate": hit_rate,
        "paged.greedy_parity_mismatches": float(mismatches),
        "paged.pallas_parity_mismatches": float(kernel_mismatches),
        "paged.row_cap_gain": paged_cap / dense_cap,
    }


@contextlib.contextmanager
def _plain_sampler():
    """Engines built inside the block decode with the plain reference
    sampler (``engine/speculative.make_masked_sampler``) in place of the
    fused sampler."""
    from bcg_tpu_torch.engine import speculative, torch_engine

    fused = torch_engine.make_fused_sampler
    torch_engine.make_fused_sampler = speculative.make_masked_sampler
    try:
        yield
    finally:
        torch_engine.make_fused_sampler = fused


def run_sampler_scenario(inject: str = "none") -> Dict[str, float]:
    """The fused guided sampler (``ops/guided_sampler.sample_rows``; its
    plain version on the CPU) against the plain reference sampler over
    the three decode-loop families on the greedy decision benchmark:
    token-identical outputs (0 mismatches) and the fused engines' wrapper
    calls (floored, so the parity cannot pass with the sampler
    disengaged)."""
    from bcg_tpu_torch.ops.guided_sampler import sample_rows

    prompts = BENCH_PROMPTS[:2]
    mismatches = 0
    fused_calls = 0
    for family_kw in ({}, {"decode_fast_forward": True}, {"spec_decode": True}):
        with _plain_sampler():
            ref = _engine(**family_kw)
            try:
                r_ref = ref.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
            finally:
                ref.shutdown()
        fused = _engine(**family_kw)
        calls = sample_rows.calls
        try:
            r_fus = fused.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
        finally:
            fused.shutdown()
        fused_calls += sample_rows.calls - calls
        mismatches += sum(1 for a, b in zip(r_ref, r_fus) if a != b)
    if inject == "fail-rows":
        mismatches += 1  # self-test hook: provoke the parity gate
    return {
        "sampler.parity_mismatches": float(mismatches),
        "sampler.fused_kernel_invocations": float(fused_calls),
    }


def run_int4_scenario(inject: str = "none") -> Dict[str, float]:
    """Packed-int4 KV cache gates: the dense admission cap (``cap_for``)
    and the paged pool's auto size of an int4 engine over its int8 twin
    at one synthetic budget; int4 paged against int4 dense greedy output
    (0 exact); every row valid guided JSON."""
    limit = 32 << 20
    caps, blocks = {}, {}
    for dtype in ("int8", "int4"):
        eng = _engine(kv_cache_dtype=dtype)
        eng._mem_limit = limit
        free = eng.config.hbm_utilization * limit - eng._param_bytes
        eng._prefix_budget = max(0, int(free * 0.25))
        caps[dtype] = eng.cap_for(256) or 1
        blocks[dtype] = eng._auto_pool_blocks(eng.config.kv_block_size)
        eng.shutdown()

    prompts = BENCH_PROMPTS[:2]
    dense = _engine(kv_cache_dtype="int4")
    paged = _engine(kv_cache_dtype="int4", paged_kv=True, paged_kv_impl="pallas")
    try:
        r_d = dense.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
        r_p = paged.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
    finally:
        dense.shutdown()
        paged.shutdown()
    mismatches = sum(1 for a, b in zip(r_d, r_p) if a != b)
    if inject == "fail-rows":
        mismatches += 1  # self-test hook
    return {
        "int4.row_cap_gain": caps["int4"] / caps["int8"],
        "int4.pool_blocks_gain": blocks["int4"] / blocks["int8"],
        "int4.paged_parity_mismatches": float(mismatches),
        "int4.error_rows": float(_bad_rows(r_d + r_p)),
    }


# Game-event types every completed game must carry (the manifest is
# per-file, checked separately).
_REQUIRED_GAME_EVENTS = ("game_start", "round_start", "decision", "deliveries", "vote",
                         "round_end", "game_end")


def _fake_game_config(seed: int, topology: str = "fully_connected"):
    import dataclasses

    from bcg_tpu_torch.config import (
        BCGConfig, EngineConfig, GameConfig, MetricsConfig, NetworkConfig,
    )

    return dataclasses.replace(
        BCGConfig(),
        game=GameConfig(num_honest=4, num_byzantine=1, max_rounds=6, seed=seed),
        network=NetworkConfig(topology_type=topology),
        engine=EngineConfig(backend="fake"),
        metrics=MetricsConfig(save_results=False),
        verbose=False,
    )


def _play(cfg) -> None:
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    sim = BCGSimulation(config=cfg)
    try:
        sim.run()
    finally:
        sim.close()


def run_consensus_scenario(inject: str = "none") -> Dict[str, float]:
    """Three seeded fake-engine games with the game-event stream on (two
    fully connected, one ring): convergence rate and rounds to consensus,
    the fraction of required event types per game (manifest checked), the
    sink's drops, and the ``game.round_ms`` histogram's quantile sanity.
    ``events-off`` unsets the stream, and the gate must name the schema
    and convergence metrics."""
    from bcg_tpu_torch.obs import counters as obs_counters, game_events

    events_path = os.path.join(tempfile.mkdtemp(prefix="bcg-torch-gate-"),
                               "game_events.jsonl")
    drops_before = obs_counters.value("game.events_dropped")
    hist_before = obs_counters.value("game.round_ms.count")
    with env_vars(BCG_TPU_GAME_EVENTS=None if inject == "events-off" else events_path):
        game_events.reset_sink()
        try:
            for seed, topology in ((7, "fully_connected"), (8, "fully_connected"),
                                   (3, "ring")):
                _play(_fake_game_config(seed, topology))
        finally:
            game_events.reset_sink()  # drain and close: the file is whole

    per_game: Dict[str, Dict] = {}
    have_manifest = False
    if os.path.exists(events_path):
        with open(events_path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event") == "manifest":
                    have_manifest = rec.get("schema_version") is not None
                    continue
                gid = rec.get("game")
                if gid is None:
                    continue
                g = per_game.setdefault(gid, {"events": set(), "converged": False, "rounds": 0})
                g["events"].add(rec["event"])
                if rec["event"] == "game_end":
                    g["converged"] = bool(rec.get("converged"))
                    g["rounds"] = int(rec.get("rounds", 0))
    n_games = len(per_game)
    converged = [g for g in per_game.values() if g["converged"]]
    completeness = (
        sum(sum(1 for e in _REQUIRED_GAME_EVENTS if e in g["events"])
            / len(_REQUIRED_GAME_EVENTS) for g in per_game.values()) / n_games
        if n_games else 0.0
    ) * (1.0 if have_manifest or not n_games else 0.0)
    try:
        hist = obs_counters.histogram("game.round_ms")
    except KeyError:
        hist = None  # the recorder never ran (events-off)
    if hist is not None and hist.count > hist_before:
        q = hist.quantiles()
        sane = float(0.0 <= q["p50"] <= q["p95"] <= q["p99"] <= hist.bounds[-1])
    else:
        sane = 0.0
    return {
        "consensus.convergence_rate": len(converged) / n_games if n_games else 0.0,
        "consensus.rounds_to_consensus_mean": (
            sum(g["rounds"] for g in converged) / len(converged) if converged else 0.0),
        "consensus.event_schema_completeness": completeness,
        "consensus.events_dropped": float(
            obs_counters.value("game.events_dropped") - drops_before),
        "consensus.histogram_quantile_sanity": sane,
    }


def run_hostsync_scenario(inject: str = "none") -> Dict[str, float]:
    """Host-sync auditor gates: syncs a round of one fake-engine game on
    the fused round (1: its one ``round_readback``) and on the lockstep
    path (2 calls x 3 mirrored syncs = 6); observed syncs per decision of
    the tiny engine's benchmark; attributed / total; error rows.
    ``hostsync-off`` unsets the auditor, and the gate must name
    syncs_per_round, syncs_per_decision and attribution_coverage."""
    from bcg_tpu_torch.obs import counters as obs_counters, hostsync as obs_hostsync

    per_round = {}
    with env_vars(BCG_TPU_HOSTSYNC=None if inject == "hostsync-off" else "1"):
        obs_hostsync.reset()
        try:
            total_before = obs_counters.value("engine.hostsync.total")
            attr_before = obs_counters.value("engine.hostsync.attributed")
            for path_name, mega in (("fused", "1"), ("lockstep", None)):
                with env_vars(BCG_TPU_MEGAROUND=mega):
                    rounds_before = obs_counters.value("game.host_syncs.count")
                    syncs_before = obs_counters.value("game.host_syncs.sum")
                    _play(_fake_game_config(7))
                    rounds = obs_counters.value("game.host_syncs.count") - rounds_before
                    syncs = obs_counters.value("game.host_syncs.sum") - syncs_before
                per_round[path_name] = syncs / rounds if rounds else 0.0

            eng_before = obs_counters.value("engine.hostsync.total")
            eng = _engine()
            try:
                results = eng.batch_generate_json(BENCH_PROMPTS, temperature=0.0,
                                                  max_tokens=64)
            finally:
                eng.shutdown()
            decision_syncs = obs_counters.value("engine.hostsync.total") - eng_before
            total = obs_counters.value("engine.hostsync.total") - total_before
            attributed = obs_counters.value("engine.hostsync.attributed") - attr_before
        finally:
            obs_hostsync.reset()
    return {
        "hostsync.syncs_per_round": per_round.get("fused", 0.0),
        "hostsync.syncs_per_round_lockstep": per_round.get("lockstep", 0.0),
        "hostsync.syncs_per_decision": decision_syncs / len(BENCH_PROMPTS),
        "hostsync.attribution_coverage": attributed / total if total else 0.0,
        "hostsync.error_rows": float(_bad_rows(results)),
    }


def run_megaround_scenario(inject: str = "none") -> Dict[str, float]:
    """Fused-round gates on the tiny engine: each of three rounds' greedy
    proposals and votes against the lockstep oracle
    (``batch_generate_json`` at temperature 0 over the same rendered
    prompts and token budgets; 0 exact), shape signatures noted after
    round 1 (0 exact: every per-round quantity is a tensor argument), and
    the warm fused round's wall against the warm lockstep pair's."""
    import numpy as np

    n, lo, hi, max_rounds = 4, 0, 50, 6
    with _compile_observer() as obs_compile:
        eng = _engine()
        try:
            plan = eng.prepare_megaround(n_agents=n, lo=lo, hi=hi, max_rounds=max_rounds)
            template = plan.template
            mask = np.ones((n, n), dtype=bool)
            np.fill_diagonal(mask, False)
            is_byz = np.zeros(n, dtype=bool)
            is_byz[-1] = True
            values = np.array([3, 17, 3, 42], dtype=np.int32)
            initials = values.copy()
            inbox = np.full((n, n), -1, dtype=np.int32)

            def parse(row, lo_, hi_):
                if not isinstance(row, dict) or "error" in row:
                    return -1
                v = row.get("value")
                if isinstance(v, bool) or not isinstance(v, int):
                    return -1
                return v if lo_ <= v <= hi_ else -1

            decision_mismatches = vote_mismatches = 0
            fused_warm = oracle_warm = 0.0
            after_first = 0
            for r in range(1, 4):
                t0 = time.perf_counter()
                res = eng.run_megaround(plan, values, inbox, r, mask, is_byz, initials)
                t_fused = time.perf_counter() - t0
                t0 = time.perf_counter()
                oracle_dec = eng.batch_generate_json(
                    template.decision_prompts(values, inbox, r),
                    temperature=0.0, max_tokens=plan.decide.max_new)
                oracle_vote = eng.batch_generate_json(
                    template.vote_prompts(res.values, res.received, r),
                    temperature=0.0, max_tokens=plan.vote.max_new)
                t_oracle = time.perf_counter() - t0
                want_dec = np.asarray([parse(row, lo, hi) for row in oracle_dec], np.int32)
                want_vote = np.asarray(
                    [1 if parse(row, 0, 1) == 1 else 0 for row in oracle_vote], np.int32)
                decision_mismatches += int((want_dec != res.proposed).sum())
                vote_mismatches += int((want_vote != res.votes).sum())
                if r == 1:
                    after_first = _signature_events(obs_compile)
                else:
                    fused_warm += t_fused
                    oracle_warm += t_oracle
                values, inbox = res.values, res.received
            steady = _signature_events(obs_compile) - after_first
        finally:
            eng.shutdown()
    return {
        "megaround.decision_mismatches": float(decision_mismatches),
        "megaround.vote_mismatches": float(vote_mismatches),
        "megaround.steady_retraces": float(steady),
        "megaround.round_speedup": oracle_warm / fused_warm if fused_warm > 0 else 0.0,
    }


def run_compile_scenario(inject: str = "none") -> Dict[str, float]:
    """Compile-cost observability gates over the port's shape seams: a
    warm identical-shape repeat notes nothing (0 exact); every counted
    retrace carries one cause record (min 0.95), provoked by the JAX
    scenario's new token budget (a new signature to no seam of the port)
    and by a new padded batch (5 rows pad to 8: a ``pad_batch`` retrace);
    the distinct (entry, signature) pairs noted; error rows.
    ``compile-off`` unsets the observer, and the gate must name
    retrace_cause_coverage and compile_cache_entries."""
    from bcg_tpu_torch.obs import counters as obs_counters

    with _compile_observer(on=inject != "compile-off") as obs_compile:
        eng = _engine()
        try:
            cold = eng.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=64)
            seen = _signature_events(obs_compile)
            warm = eng.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=64)
            steady = _signature_events(obs_compile) - seen
            observer = obs_compile.observer()
            retraces_before = observer.brief()["retraces"] if observer else 0
            before_provoke = obs_counters.snapshot()
            provoked = eng.batch_generate_json(BENCH_PROMPTS, temperature=0.0, max_tokens=96)
            provoked += eng.batch_generate_json(BENCH_PROMPTS + BENCH_PROMPTS[:2],
                                                temperature=0.0, max_tokens=64)
            provoke_moved = obs_counters.delta(before_provoke)
            retraces = (observer.brief()["retraces"] if observer else 0) - retraces_before
            entries = _signature_events(obs_compile)
        finally:
            eng.shutdown()
    causes = sum(v for k, v in provoke_moved.items() if k.startswith("engine.retrace_cause."))
    return {
        "compile.steady_state_retraces": float(steady),
        "compile.retrace_cause_coverage": causes / retraces if retraces else 0.0,
        "compile.compile_cache_entries": float(entries),
        "compile.error_rows": float(_bad_rows(cold + warm + provoked)),
    }


def run_sweep_scenario(inject: str = "none") -> Dict[str, float]:
    """Multi-tenant scheduling gates, deterministic because the device is
    plugged (``run_exclusive`` holds the device lock) while requests
    queue: the light tenant's mean normalized batch position against a
    heavy flood (``fairness-off`` must fail naming it), the batch count
    floor, an 8-row quota's exactness and deferral with a positive
    retry-after, the retry-after derivation's monotonicity, error rows."""
    from bcg_tpu_torch.engine.fake import FakeEngine
    from bcg_tpu_torch.serve.scheduler import (
        AdmissionDeferred, Scheduler, derive_retry_after_ms,
    )

    class RecordingEngine:
        """Records each dispatched batch's row markers (the first
        character of every user prompt), with a small device latency so
        dispatches are distinct batches."""

        def __init__(self):
            self.inner = FakeEngine(seed=0, policy="consensus")
            self.batches: List[List[str]] = []

        def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
            self.batches.append([p[1][0] for p in prompts])
            time.sleep(0.002)
            return self.inner.batch_generate_json(prompts, temperature=temperature,
                                                  max_tokens=max_tokens)

    def plug(sched):
        release, plugged = threading.Event(), threading.Event()

        def hold():
            plugged.set()
            release.wait()

        t = threading.Thread(target=lambda: sched.run_exclusive(hold))
        t.start()
        plugged.wait(10)
        return release, t

    def row(marker: str):
        return ("agent system prompt",
                f"{marker} Round 2. agent_1 value: 17. Your current value: 17. Decide.",
                DECISION)

    def drain_queue(sched, deadline_s: float = 10.0) -> None:
        t0 = time.monotonic()
        poll_s = 0.0005
        while sched.queue_depth_rows() > 0:
            if time.monotonic() - t0 > deadline_s:
                raise RuntimeError("scheduler never picked up the seed batch")
            time.sleep(poll_s)
            poll_s = min(poll_s * 2, 0.01)

    def submit(sched, marker, tenant):
        return sched.submit(("json",), [row(marker)] * 4, [0.0] * 4, [64] * 4, tenant=tenant)

    eng = RecordingEngine()
    sched = Scheduler(eng, linger_ms=0, bucket_rows=8, max_queue_rows=4096, deadline_ms=0,
                      strict_admission=False, fair=(inject != "fairness-off"))
    sched.register_tenant("heavy", weight=1.0)
    sched.register_tenant("light", weight=1.0)
    release, plug_thread = plug(sched)
    try:
        reqs = [submit(sched, "H", "heavy")]
        drain_queue(sched)  # the seed batch in flight, blocked on the plug
        reqs += [submit(sched, "H", "heavy") for _ in range(15)]
        reqs += [submit(sched, "L", "light") for _ in range(2)]
    finally:
        release.set()
        plug_thread.join(10)
    for r in reqs:
        r.done.wait(30)
    sched.close()
    bad = sum(_bad_rows(r.results or []) for r in reqs)
    n_batches = len(eng.batches)
    light_idx = [i for i, b in enumerate(eng.batches) if "L" in b]
    starvation = (sum(light_idx) / len(light_idx) / max(1, n_batches - 1)
                  if light_idx else 1.0)

    sched2 = Scheduler(FakeEngine(seed=0, policy="consensus"), linger_ms=0,
                       max_queue_rows=4096, deadline_ms=0, strict_admission=False)
    q = sched2.register_tenant("quotatenant", quota_rows=8)
    release2, plug2 = plug(sched2)
    retry_ms = 0.0
    try:
        first = submit(sched2, "Q", "quotatenant")
        drain_queue(sched2)
        fills = [submit(sched2, "Q", "quotatenant") for _ in range(2)]
        over = submit(sched2, "Q", "quotatenant")
        if isinstance(over.error, AdmissionDeferred):
            retry_ms = over.error.retry_after_s * 1e3
    finally:
        release2.set()
        plug2.join(10)
    for r in [first] + fills:
        r.done.wait(30)
    sched2.close()

    slo = 50
    grid = [derive_retry_after_ms(20.0, 10.0, slo_ms=slo, headroom_p50_ms=float(h))
            for h in range(0, slo + 1, 5)]
    monotone = all(a >= b for a, b in zip(grid, grid[1:]))
    return {
        "sweep.starvation_ratio": starvation,
        "sweep.fairness_batches": float(n_batches),
        "sweep.quota_overrun_rows": float(max(0, q.max_queued_rows - 8)),
        "sweep.quota_deferrals": float(q.deferrals),
        "sweep.retry_after_live_ms": retry_ms,
        "sweep.retry_after_monotonicity": float(monotone and grid[0] >= 2.0 * grid[-1]),
        "sweep.error_rows": float(bad),
    }


_SERVE_CHAOS = ("seed=7;crash@serve.dispatch:2;hang@serve.dispatch:4:4.0;"
                "exhaust@serve.dispatch:6")


def _chaos_scheduler():
    from bcg_tpu_torch.engine.fake import FakeEngine
    from bcg_tpu_torch.serve.scheduler import Scheduler

    return Scheduler(
        FakeEngine(seed=0, policy="consensus"), linger_ms=0, bucket_rows=4,
        max_queue_rows=4096, deadline_ms=0, strict_admission=False,
        max_dispatch_retries=2, watchdog_s=1.5,
        engine_factory=lambda: FakeEngine(seed=0, policy="consensus"),
    )


def run_chaos_scenario(inject: str = "none") -> Dict[str, float]:
    """Chaos seams and the recovery tier: a fake-engine serving run (2
    waves x 8 threads x 2 rows, 4-row bucket, 2 retries, 1.5 s watchdog
    with an engine factory) under a crash on dispatch pass 2, a 4 s hang
    on pass 4 and a pool exhaustion on pass 6, every one recovered, the
    recovery counters exactly where the spec puts them; and a 3-job sweep
    with a transient crash on job pass 2, requeued and reported once
    (duplicates read by ``scripts/consensus_report.py``).  ``chaos-off``
    unsets ``BCG_TPU_CHAOS``, and the gate must name the retry, recovery
    and rebuild metrics."""
    from bcg_tpu_torch.engine.fake import FakeEngine
    from bcg_tpu_torch.obs import counters as obs_counters
    from bcg_tpu_torch.runtime import resilience
    from bcg_tpu_torch.sweep.controller import run_sweep

    chaos_on = inject != "chaos-off"
    before = obs_counters.snapshot()
    sweep_dir = os.path.join(tempfile.mkdtemp(prefix="bcg-torch-chaos-gate-"), "sweep")
    try:
        with env_vars(BCG_TPU_CHAOS=_SERVE_CHAOS if chaos_on else None):
            resilience.reset()
            sched = _chaos_scheduler()
            rows, error_rows, errors = _serve_requests(sched)
            snap = sched.snapshot()
            sched.close()
        with env_vars(BCG_TPU_CHAOS="seed=7;crash@sweep.job:2" if chaos_on else None):
            resilience.reset()
            summary = run_sweep(
                {"name": "chaos-sweep",
                 "base": {"agents": 3, "byzantine": 0, "max_rounds": 3, "backend": "fake"},
                 "axes": {"seed": [1, 2, 3]}},
                sweep_dir, max_concurrent=1,
                engine=FakeEngine(seed=0, policy="consensus"), max_job_retries=2,
            )
    finally:
        resilience.reset()
    moved = obs_counters.delta(before)

    cr = load_report("consensus_report")
    games, problems = [], []
    for path in sorted(glob.glob(os.path.join(sweep_dir, "events-*.jsonl"))):
        games.extend(cr.parse_file(path, problems))
    dup_problems = cr.duplicate_job_problems(games)
    try:
        hist = obs_counters.histogram("serve.recovery_ms")
        q = hist.quantiles()
        hist_sane = float(moved.get("serve.recovery_ms.count", 0) > 0
                          and 0.0 <= q["p50"] <= q["p95"] <= q["p99"] <= hist.bounds[-1])
    except KeyError:
        hist_sane = 0.0
    if errors:
        raise errors[0]
    return {
        "chaos.completed_fraction": snap["completed"] / max(1, snap["submitted"]),
        "chaos.lost_futures": float(snap["pending"]),
        "chaos.failed_requests": float(snap["failed"]),
        "chaos.error_rows": float(error_rows),
        "chaos.dispatch_retries": moved.get("serve.dispatch_retries", 0),
        "chaos.batch_splits": moved.get("serve.batch_splits", 0),
        "chaos.recoveries": moved.get("serve.recoveries", 0),
        "chaos.engine_rebuilds": moved.get("serve.engine_rebuilds", 0),
        "chaos.faults_injected": moved.get("chaos.injected", 0),
        "chaos.recovery_hist_sanity": hist_sane,
        "chaos.sweep_completed_fraction": summary["completed"] / max(1, len(summary["results"])),
        "chaos.sweep_jobs_retried": moved.get("sweep.jobs.retried", 0),
        "chaos.sweep_duplicate_job_problems": float(len(dup_problems)),
    }


def run_scenarios_scenario(inject: str = "none") -> Dict[str, float]:
    """Adversary library and scenario registry gates: a 4-scenario
    fake-engine sweep (adaptive-margin, baseline-disrupt,
    clique-collusion, equivocation-split) through the sweep controller,
    read by ``scripts/consensus_report.py``: per-strategy influence
    floors, equivocation divergence rows (and 0 off-strategy), the clique
    decisions' agreement with ``clique_target``, strategies covered,
    error rows.  ``scenarios-off`` runs plain jobs of the same grid shape,
    and every one of those must fail."""
    from bcg_tpu_torch.scenarios.strategies import clique_target
    from bcg_tpu_torch.sweep.controller import run_sweep

    scen = ["adaptive-margin", "baseline-disrupt", "clique-collusion", "equivocation-split"]
    if inject == "scenarios-off":
        spec = {"name": "scenarios-gate",
                "base": {"agents": 6, "byzantine": 2, "max_rounds": 6},
                "axes": {"seed": [0, 1, 2, 3]}}
    else:
        spec = {"name": "scenarios-gate", "axes": {"scenario": scen}}
    out_dir = os.path.join(tempfile.mkdtemp(prefix="bcg-torch-scen-gate-"), "sweep")
    run_sweep(spec, out_dir, max_concurrent=1, max_job_retries=2)

    cr = load_report("consensus_report")
    games: List = []
    problems: List[str] = []
    event_files = sorted(glob.glob(os.path.join(out_dir, "events-*.jsonl")))
    for path in event_files:
        games.extend(cr.parse_file(path, problems))

    influence: Dict[str, int] = {}
    equiv_rows = off_rows = invalids = 0
    strategies = set()
    for g in games:
        if not g.ended:
            continue
        invalids += g.invalids
        if g.strategy:
            strategies.add(g.strategy)
            influence[g.strategy] = influence.get(g.strategy, 0) + g.influence
            if g.strategy == "equivocate":
                equiv_rows += g.equivocation_rows
            else:
                off_rows += g.equivocation_rows

    clique_hits = clique_total = 0
    for path in event_files:
        meta: Dict[str, Dict] = {}
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("event") == "game_start":
                    meta[rec["game"]] = rec
                elif (rec.get("event") == "decision" and rec.get("role") == "byzantine"
                      and rec.get("value") is not None):
                    start = meta.get(rec.get("game"))
                    if start and start.get("strategy") == "clique":
                        lo_, hi_ = start["value_range"]
                        clique_total += 1
                        clique_hits += int(
                            rec["value"] == clique_target(start.get("seed"), lo_, hi_))
    return {
        "scenarios.influence_disrupt": float(influence.get("disrupt", 0)),
        "scenarios.influence_clique": float(influence.get("clique", 0)),
        "scenarios.influence_adaptive": float(influence.get("adaptive", 0)),
        "scenarios.influence_equivocate": float(influence.get("equivocate", 0)),
        "scenarios.equivocation_divergence_rows": float(equiv_rows),
        "scenarios.offstrategy_divergence_rows": float(off_rows),
        "scenarios.clique_shared_target_agreement": (
            clique_hits / clique_total if clique_total else 0.0),
        "scenarios.strategies_covered": float(len(strategies)),
        "scenarios.error_rows": float(invalids),
    }


def run_hlo_scenario(inject: str = "none") -> Dict[str, float]:
    """The census drift findings of ``python -m
    bcg_tpu_torch.tools.census_gate --check`` against its ``cpu`` section,
    in a subprocess, so the census records of this process's earlier
    scenarios cannot enter it."""
    proc = subprocess.run(
        [sys.executable, "-m", "bcg_tpu_torch.tools.census_gate", "--check"],
        capture_output=True, text=True, timeout=580, cwd=REPO,
    )
    findings = [line for line in proc.stderr.splitlines() if line.startswith("DRIFT: ")]
    if proc.returncode not in (0, 2):  # a crash, not a drift verdict
        findings.append(f"census subprocess failed rc={proc.returncode}: "
                        + proc.stderr.strip()[-300:])
    for f in findings:
        print(f"perf_gate[hlo]: {f}", file=sys.stderr)
    return {"hlo.census_drift_findings": float(len(findings))}


def run_alerts_scenario(inject: str = "none") -> Dict[str, float]:
    """The alerting plane over the chaos scenario's serving recipe (3
    faults), with the periodic evaluator parked (``BCG_TPU_ALERT_MS`` an
    hour) so every cycle is driven here: a fault-free oracle run fires
    nothing (from a reset registry); the chaos run fires each expected
    recovery rule once, every episode resolves on the quiet cycles,
    nothing unexpected fires, health and readiness flip and recover, and
    the alert stream's records match the engine's totals.
    ``alerts-off`` unsets ``BCG_TPU_ALERTS``, and the gate must name
    rules_evaluated, chaos_alerts_fired, fault_coverage, healthz_flip and
    event_stream_ok."""
    from bcg_tpu_torch.engine.fake import FakeEngine
    from bcg_tpu_torch.obs import alerts as obs_alerts
    from bcg_tpu_torch.obs import counters as obs_counters
    from bcg_tpu_torch.runtime import resilience
    from bcg_tpu_torch.serve.scheduler import Scheduler

    events_path = os.path.join(tempfile.mkdtemp(prefix="bcg-torch-alert-gate-"),
                               "alerts.jsonl")
    expected = ("engine_errors", "engine_rebuilt", "dispatch_retries")
    saw_failing = False
    with env_vars(BCG_TPU_ALERTS="1" if inject != "alerts-off" else None,
              BCG_TPU_ALERT_MS="3600000", BCG_TPU_ALERT_EVENTS=events_path,
              BCG_TPU_CHAOS=None):
        # Threshold and staleness rules read absolute registry values: the
        # 0-exact false-positive pin needs a pristine registry.
        obs_counters.reset()
        obs_alerts.reset()
        obs_alerts.reset_readiness()
        resilience.reset()
        try:
            sched = Scheduler(FakeEngine(seed=0, policy="consensus"), linger_ms=0,
                              bucket_rows=4, max_queue_rows=4096, deadline_ms=0,
                              strict_admission=False)
            obs_alerts.evaluate_now()  # the base snapshot: rate rules need two
            for _ in range(2):
                sched.submit_and_wait(("json",), list(SERVE_PAYLOAD), [0.0] * 2, [64] * 2)
                obs_alerts.evaluate_now()
            sched.close()
            obs_alerts.evaluate_now()
            eng = obs_alerts.engine()
            false_pos = float(eng.fired) if eng is not None else 0.0

            before = obs_counters.snapshot()
            with env_vars(BCG_TPU_CHAOS=_SERVE_CHAOS):
                resilience.reset()
                sched = _chaos_scheduler()
                obs_alerts.evaluate_now()  # a fresh base: wave deltas only
                errors: List[BaseException] = []
                for _wave in range(2):
                    _, _, wave_errors = _serve_requests(sched, waves=1)
                    errors += wave_errors
                    obs_alerts.evaluate_now()
                    ok, _ = obs_alerts.health()
                    saw_failing = saw_failing or not ok
                sched.close()
            for _ in range(2):  # quiet cycles: every episode must resolve
                obs_alerts.evaluate_now()
            final_ok, _ = obs_alerts.health()

            moved = obs_counters.delta(before)
            injected = moved.get("chaos.injected", 0)
            if eng is not None:
                by_rule = eng.fired_by_rule()
                evaluations, flaps = float(eng.evaluations), float(eng.flaps)
                unresolved = float(len(eng.firing()))
                total_fired, total_resolved = eng.fired, eng.resolved
            else:
                by_rule = {}
                evaluations = flaps = unresolved = 0.0
                total_fired = total_resolved = 0
            chaos_fired = float(sum(by_rule.get(r, 0) for r in expected))
            unexpected = float(total_fired) - chaos_fired - false_pos
            hist = obs_alerts.readiness_history()
            engine_flips = sum(1 for h in hist
                               if not h["ready"] and "engine" in h["reasons"])
            readyz_flip = float(engine_flips if hist and hist[-1]["ready"] else 0)

            # Stop the evaluator and close the sink (it drains), so the
            # stream compares with the engine's totals.
            obs_alerts.reset()
            firing_recs = resolved_recs = 0
            manifest_first = False
            try:
                with open(events_path) as f:
                    recs = [json.loads(line) for line in f if line.strip()]
                manifest_first = bool(recs) and recs[0].get("event") == "manifest"
                firing_recs = sum(1 for r in recs
                                  if r.get("event") == "alert" and r.get("state") == "firing")
                resolved_recs = sum(1 for r in recs if r.get("event") == "alert"
                                    and r.get("state") == "resolved")
            except OSError:
                pass  # alerts-off: no engine, no sink, no file
            stream_ok = float(manifest_first and total_fired > 0
                              and firing_recs == total_fired
                              and resolved_recs == total_resolved)
        finally:
            obs_alerts.reset()
            obs_alerts.reset_readiness()
            resilience.reset()
    if errors:
        raise errors[0]
    return {
        "alerts.rules_evaluated": evaluations,
        "alerts.chaos_alerts_fired": chaos_fired,
        "alerts.fault_coverage": chaos_fired / max(1.0, float(injected)),
        "alerts.false_positives": false_pos,
        "alerts.flaps": flaps,
        "alerts.unresolved_at_end": unresolved,
        "alerts.unexpected_alerts": unexpected,
        "alerts.readyz_flip": readyz_flip,
        "alerts.healthz_flip": float(saw_failing and final_ok),
        "alerts.event_stream_ok": stream_ok,
    }


RUNNERS = {
    "serve": run_serve_scenario,
    "engine": run_engine_scenario,
    "paged": run_paged_scenario,
    "sampler": run_sampler_scenario,
    "int4": run_int4_scenario,
    "consensus": run_consensus_scenario,
    "hostsync": run_hostsync_scenario,
    "megaround": run_megaround_scenario,
    "compile": run_compile_scenario,
    "sweep": run_sweep_scenario,
    "chaos": run_chaos_scenario,
    "scenarios": run_scenarios_scenario,
    "hlo": run_hlo_scenario,
    "alerts": run_alerts_scenario,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's CPU-hermetic counter-derived perf gate.")
    parser.add_argument("--scenarios", default=",".join(SCENARIOS),
                        help=f"comma list of {SCENARIOS}")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite tools/perf_baseline.json (keeps reasons and bands)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the measured metrics as JSON")
    parser.add_argument("--inject-regression", default="none", choices=REGRESSIONS,
                        help="self-test: provoke a known regression and confirm "
                        "the gate names it")
    args = parser.parse_args(argv)

    scenarios = tuple(s for s in args.scenarios.split(",") if s)
    bad = [s for s in scenarios if s not in SCENARIOS]
    if bad:
        print(f"unknown scenarios {bad}; known: {SCENARIOS}", file=sys.stderr)
        return 1
    measured: Dict[str, float] = {}
    for s in scenarios:
        measured.update(RUNNERS[s](args.inject_regression))
    if args.as_json:
        print(json.dumps(measured, indent=2, sort_keys=True))
    else:
        width = max(len(n) for n in measured)
        for name, got in sorted(measured.items()):
            print(f"{name:<{width}}  {got:.4f}")
    if args.update_baseline:
        print(f"baseline written: {gate_baseline.update_baseline(measured)}",
              file=sys.stderr)
        return 0
    baseline = gate_baseline.load_baseline()
    findings = gate_baseline.check_metrics(measured, baseline)
    findings += gate_baseline.check_stale(measured, baseline, scenarios)
    for f in findings:
        print(f"PERF REGRESSION: {f}", file=sys.stderr)
    if findings:
        return 2
    print("perf gate green", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
