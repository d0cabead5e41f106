"""The benchmark of the PyTorch/H100 port (``bcg_tpu_torch``).

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  One run:

1. Set-up: load the cell's configuration and traffic files (found by name,
   ``registry.py``), set the allocator settings the configuration names
   before torch starts, build the program's kernel libraries into the
   checkout's ``build/bcg_tpu_torch/`` (once per checkout), draw the
   weights on the card from ``--seed`` (``weights.py``), boot the
   program's ``TorchEngine`` over them, and play ``warmup_rounds`` whole
   rounds of every game of the traffic mix (``traffic.py``).
   ``setup_s`` is process start to window start.
2. Window: the clients play whole rounds, starting one only while fewer
   than ``--seconds`` have passed; the window closes when the last round
   started in it ends, so it overruns ``--seconds`` by up to one round.
   With ``--trace 1`` the window is one whole round of every game, all of
   it under the profiler.
3. The window's peak memory is read, the program is freed, and the
   served rows are held to the plain reference (``check.py``).
4. The last line of standard output is one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, with
   ``--trace 1`` ``breakdown``, then ``info`` and, last, ``checks``: each
   number compared beside its limit, which also end standard error.

A run exits non-zero with no result when there is no CUDA card (or fewer
than the cell asks for), when the window had no decode step, and when a
module of JAX or of the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "bcg_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, taken whole, is JAX's or the
    JAX package's (``bcg_tpu_torch`` is not ``bcg_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def prepare_environment(cfg: Dict) -> None:
    """Settings that must precede torch's start: the allocator's, and the
    kernel caches at fixed paths inside the checkout."""
    alloc = cfg["bench"].get("allocator")
    if alloc:
        os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    cache = os.path.join(CHECKOUT, "build", "h100_bench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")
    # One process, few threads: the host dispatch that paces the window
    # shares the machine with nothing of the benchmark's own.
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


@dataclass
class RunData:
    """What a run hands its metric readers."""
    model: Dict
    bench: Dict
    settings: Dict                                    # the engine's, configuration and traffic
    device_name: str
    setup_s: float
    window_s: float
    rounds: int
    decisions: int
    peak_bytes: int
    calls: int = 0                                    # engine calls (each one prefill)
    rows: List = field(default_factory=list)          # check.Judged of the window
    engine: Dict = field(default_factory=dict)        # counter deltas
    scheduler: Dict = field(default_factory=dict)     # counter deltas
    trace: Optional[object] = None                    # trace.TraceSummary


def check_spec(model: Dict, spec) -> None:
    want = {"hidden_size": spec.hidden_size, "intermediate_size": spec.intermediate_size,
            "num_hidden_layers": spec.num_layers, "num_attention_heads": spec.num_heads,
            "num_key_value_heads": spec.num_kv_heads, "head_dim": spec.head_dim,
            "vocab_size": spec.vocab_size, "rope_theta": spec.rope_theta,
            "rms_norm_eps": spec.rms_eps, "tie_word_embeddings": spec.tie_embeddings,
            "attention_bias": spec.attn_bias}
    bad = {k: (model.get(k), v) for k, v in want.items() if model.get(k) != v}
    if bad or not spec.qk_norm or spec.rope_scaling is not None:
        raise ValueError(f"the preset's sizes differ from the configuration's: {bad}")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def execute(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t_start: float = T_START, registry=None,
            after_boot: Optional[Callable] = None, with_control: bool = False) -> Dict:
    """One run of ``cell``; returns the result object.  ``after_boot``
    (tests) is called with the engine once it is built; ``with_control``
    (``h100_bench.control`` only, never a benchmark run) also reads the
    gaps of the reference computed in the next precision below the
    configuration's, into ``info``."""
    import torch

    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model

    from h100_bench import check, weights
    from h100_bench.reference.qwen3 import Reference
    from h100_bench.trace import Profiled
    from h100_bench.traffic import Driver, Recorder, derived_seed

    cfg, trf = cell.config, cell.traffic
    bench = cfg["bench"]
    model = cfg
    is_cuda = torch.device(device).type == "cuda"
    spec = spec_for_model(bench["preset"])
    check_spec(model, spec)
    stamps = {}

    if is_cuda:
        from bcg_tpu_torch.ops import _build

        _build.build_all()
        stamps["kernels_built"] = time.perf_counter() - t_start
    params = weights.draw(model, seed, device)
    _sync(device)
    stamps["weights_drawn"] = time.perf_counter() - t_start
    settings = dict(bench.get("engine", {}))
    ecfg = EngineConfig(backend="torch", model_name=bench["preset"],
                        fake_seed=derived_seed(seed, "sampler"), **settings)
    engine = TorchEngine(ecfg, device=device, params=params)
    params = None  # the engine holds what it serves; the reference draws anew
    if after_boot is not None:
        after_boot(engine)
    recorder = Recorder(engine)
    driver = Driver(engine, trf, ecfg, seed)
    _sync(device)
    stamps["engine_booted"] = time.perf_counter() - t_start
    driver.play(rounds=trf["warmup_rounds"])
    _sync(device)
    stamps["warmed_up"] = time.perf_counter() - t_start

    # ---------------------------------------------------------- the window
    gc.collect()
    if is_cuda:
        torch.cuda.reset_peak_memory_stats()
    engine.max_kv_cache_bytes = 0
    steps0 = engine.total_decode_steps
    failed0 = engine.failed_rows
    sched0 = driver.scheduler_counts()
    with Profiled(trace and is_cuda) as prof:
        t0 = time.perf_counter()
        # The traced window is one whole round of every game: stopping
        # the profiler over a longer one costs more than the run allows.
        rounds, decisions = (driver.play(rounds=1) if trace and is_cuda
                             else driver.play(seconds=seconds))
        _sync(device)
        t1 = time.perf_counter()
    window_s = t1 - t0
    setup_s = t0 - t_start
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    summary = prof.summary(window_s)
    sched1 = driver.scheduler_counts()
    calls = recorder.since(t0)
    engine_delta = {"decode_steps": engine.total_decode_steps - steps0,
                    "failed_rows": engine.failed_rows - failed0,
                    "max_kv_cache_bytes": engine.max_kv_cache_bytes}
    if engine_delta["decode_steps"] <= 0:
        raise RuntimeError("the window ran no decode step")
    driver.close()
    engine.shutdown()
    del engine, driver, recorder
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ImportError(f"modules of JAX or of the JAX package loaded: {found}")
    stamps["program_freed"] = time.perf_counter() - t_start

    # ---------------------------------------------------- the comparison
    rows = [r for c in calls for r in c.rows]
    judged = check.judge_rows(rows, bench["tokenizer"], int(ecfg.max_model_len))
    violations = sum(1 for j in judged if j.fault is not None)
    picked = check.sample(judged, derived_seed(seed, "sample"), int(trf["check_tokens"]))
    gap = control = None
    if picked:
        ref_params = weights.draw(model, seed, device)
        ref = Reference(ref_params, model, int4_group=bench.get("int4_group"))
        ref_logits = check.reference_logits(ref, picked)
        gap = check.gaps(ref_logits, picked)
        if with_control:
            low = Reference(ref_params, model, int4_group=bench.get("int4_group"), control="fp8")
            control = check.gaps(ref_logits, picked, check.reference_logits(low, picked))
            margin = check.margins(ref_logits, picked)
            del low
        del ref, ref_params, ref_logits
        gc.collect()
    stamps["checked"] = time.perf_counter() - t_start
    limits = bench["limits"]
    tokens = sum(len(j.served) for j in picked)
    max_gap = float(gap.max()) if gap is not None else None
    checks = {
        "schema_violations": {"value": violations, "limit": limits["schema_violations"]},
        "max_logit_gap": {"value": max_gap, "limit": limits["max_logit_gap"]},
        "greedy_tokens_compared": {"value": tokens, "least": 1},
    }
    correct = (violations <= limits["schema_violations"] and max_gap is not None
               and max_gap <= limits["max_logit_gap"] and tokens >= 1)

    run = RunData(model=model, bench=bench, settings=settings,
                  device_name=torch.cuda.get_device_name() if is_cuda else "cpu",
                  setup_s=setup_s, window_s=window_s, rounds=rounds, decisions=decisions,
                  peak_bytes=int(peak), calls=len(calls), rows=judged, engine=engine_delta,
                  scheduler={k: sched1[k] - sched0[k] for k in sched0},
                  trace=summary)
    metrics = {}
    for name, mod in (registry.metrics(cell.per_layer if trace else cell.end_to_end)).items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": mod.UNIT}
    result = {
        "correct": bool(correct),
        "attempted": len(rows),
        "failed": sum(1 for r in rows if not isinstance(r.result, dict) or "error" in r.result),
        "metrics": metrics,
        "device": {"platform": "gpu" if is_cuda else "cpu", "kind": run.device_name,
                   "count": cell.chips if is_cuda else 0, "memory_peak_bytes": int(peak)},
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown()
    result["info"] = {
        "rounds": rounds, "decisions": decisions, "window_s": window_s, "setup_s": setup_s,
        "stamps_s": stamps, "rows": len(rows), "calls": len(calls),
        "rows_compared": len(picked), "profiler_stop_s": prof.stop_s,
        "power_limit": power_limit() if is_cuda else None,
        "engine": engine_delta, "scheduler": run.scheduler,
        "faults": sorted({j.fault for j in judged if j.fault})[:5],
        "mean_logit_gap": float(gap.mean()) if gap is not None else None,
        "free_positions": sum(1 for j in picked for cands, eos_ok in j.positions
                              if len(cands) + int(eos_ok) > 1),
        "nonzero_gaps": int((gap > 0).sum()) if gap is not None else None,
        "device_s_by_kind": summary.seconds_by_kind() if summary is not None else None,
        "calls_s": [[c.t1 - c.t0, len(c.rows), max(len(r.text or "") for r in c.rows)]
                    for c in calls],
    }
    if control is not None:
        result["info"]["control_mean_gap"] = float(control.mean())
        result["info"]["control_max_gap"] = float(control.max())
        result["info"]["control_nonzero_gaps"] = int((control > 0).sum())
        result["info"]["reference_margins"] = {
            f"q{q}": float(margin.quantile(q / 100)) for q in (0, 1, 10, 50)} if len(margin) else {}
        result["info"]["compared_heads"] = [(j.row.text or "")[:120] for j in picked]
    result["checks"] = checks
    return result


def check_lines(checks: Dict) -> List[str]:
    out = []
    for name, c in checks.items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['least']}"
        out.append(f"check {name}: {c['value']} ({bound})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from h100_bench.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    prepare_environment(cell.config)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                     registry=registry)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
