"""Central registry of environment flags — the ONLY module that reads them.

The port's copy of ``bcg_tpu/runtime/envflags.py``: the same typed
accessors (:func:`get_bool`, :func:`get_int`, :func:`get_str`) over the
subset of the registry that the port's modules read.  An accessor call
with an unregistered name raises, so a typo'd flag name is an error,
not a silently-ignored knob.

Reading is always at CALL time, never import time, so tests can
``monkeypatch.setenv`` freely.  ``python -m
bcg_tpu_torch.runtime.envflags`` prints the registry as a markdown
table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

_FALSY = ("0", "false", "no", "off")


@dataclass(frozen=True)
class EnvFlag:
    """One registered environment knob."""

    name: str
    kind: str  # "bool" | "int" | "str"
    default: Union[bool, int, str, None]
    doc: str


REGISTRY: Dict[str, EnvFlag] = {}


def _register(name: str, kind: str, default, doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"env flag {name!r} registered twice")
    REGISTRY[name] = EnvFlag(name=name, kind=kind, default=default, doc=doc)


# --------------------------------------------------------------- registry
_register(
    'VERBOSE', 'bool', False,
    'Force RunLogger console verbosity (reference repo convention).',
)
_register(
    'BCG_TPU_TIMING', 'bool', False,
    'Print per-call prefill/decode wall times and the boot-phase '
    'breakdown to stderr.',
)
_register(
    'BCG_TPU_FINE_SUFFIX', 'bool', False,
    'Enable the fine suffix-length bucket ladder (adds 1536/3072 '
    'rungs); bench/sweep override for '
    'EngineConfig.fine_suffix_buckets.',
)
_register(
    'BCG_TPU_SPEC', 'bool', False,
    'Prompt-lookup speculative decoding (engine/speculative.py): '
    'n-gram drafts verified in one K+1-position forward pass; token- '
    'identical at temperature 0, rejection sampling above.  Override '
    'for EngineConfig.spec_decode.',
)
_register(
    'BCG_TPU_SPEC_K', 'int', 4,
    'Max draft tokens per speculative verify pass (EngineConfig.spec_k '
    'override; chunk width is K+1).',
)
_register(
    'BCG_TPU_SPEC_NGRAM', 'int', 3,
    'Prompt-lookup match length in tokens (EngineConfig.spec_ngram '
    'override).',
)
_register(
    'BCG_TPU_FUSED_SAMPLER', 'str', '',
    'Fused guided-sampling Pallas kernel (EngineConfig.fused_sampler '
    "override): 'pallas' = the whole per-step [B, V] masked-sampler "
    'pipeline as one kernel program per row (ops/guided_sampler.py; '
    "interpret mode off-TPU), 'xla' = the reference sampler (the "
    "conformance oracle), 'auto'/unset = pallas on TPU, xla "
    'elsewhere.',
)
_register(
    'BCG_TPU_KV_DTYPE', 'str', '',
    'KV-cache dtype override (EngineConfig.kv_cache_dtype): '
    "'bf16'/'bfloat16', 'int8' (historical spelling kept as an alias "
    "of itself), or 'int4' (packed two-per-byte + bf16 scales — the "
    'capacity knob that roughly doubles admissible batch vs int8 at a '
    'fixed HBM budget); unset = the config field.',
)
_register(
    'BCG_TPU_PAGED_KV', 'bool', False,
    'Enable the block-paged KV cache with radix-tree prefix sharing '
    '(EngineConfig.paged_kv override): shared prompt prefixes are '
    'stored once in a block pool and referenced per row via block '
    'tables; greedy output token-identical to the dense path.',
)
_register(
    'BCG_TPU_KV_BLOCK_SIZE', 'int', 0,
    'Tokens per KV block for the paged cache (0 = use '
    'EngineConfig.kv_block_size, default 16).',
)
_register(
    'BCG_TPU_KV_POOL_BLOCKS', 'int', 0,
    'Paged KV pool size in blocks (0 = use EngineConfig.kv_pool_blocks, '
    'whose 0 = auto-size from the device memory budget / CPU-test allowance).',
)
_register(
    'BCG_TPU_PAGED_KV_IMPL', 'str', '',
    'Paged decode-attention implementation (EngineConfig.paged_kv_impl '
    "override).  On CUDA 'auto' and 'pallas' both run the paged kernel "
    "(csrc/paged_attention.cu) and 'xla' (the gather oracle) is refused; "
    'on the CPU every value runs the plain gather version.',
)
_register(
    'BCG_TPU_W8A16_PREFILL', 'int', 0,
    'Row-count threshold routing prefill-shaped int8 matmuls through '
    'the experimental W8A16 path (0 = off; bench A/B knob).',
)
_register(
    'BCG_TPU_DISABLE_W4_KERNEL', 'bool', False,
    'Kill switch of the W4A16 matmul kernel: on the CPU, int4 matmuls '
    'take the dequantize route; on CUDA an int4 engine raises (the card '
    'never serves the plain version).',
)
_register(
    'BCG_TPU_SCENARIO', 'str', None,
    'Adversary scenario from the registry (bcg_tpu/scenarios): any '
    "BCGSimulation construction overlays the named entry's strategy, "
    'topology, channel, awareness, and agent split onto its config '
    '(apply_scenario) — bench/api/CLI single runs get registry-true '
    'adversary configs without new plumbing.  Unknown names fail '
    'loudly; unset = the config as given.',
)
_register(
    'BCG_TPU_SERVE_CHECKPOINT_EVERY', 'int', 0,
    'Write a resumable checkpoint every N game rounds '
    '(runtime/checkpoint.py), independent of --checkpoint-every- '
    'round; 0 = off.',
)
_register(
    'BCG_TPU_MEGAROUND', 'bool', False,
    'On-device mega-round (ROADMAP item 1, engine/megaround.py): run '
    'each consensus round as ONE fused jit entry (prompt assembly, '
    'guided decode, in-jit parse, masked exchange, vote tally) with a '
    'single per-round readback.  Equivalent to AgentConfig.megaround; '
    'unsupported configurations (free-text decisions, sequential '
    'orchestrator, paged/multi-device engines, non-byte-stable '
    'tokenizers) fall back to the lockstep path with a one-time '
    'warning.',
)
_register(
    'BCG_TPU_FAULT_RATE', 'str', '',
    'Seeded response-corruption rate for FaultInjectingEngine '
    '(engine/fault.py), overriding EngineConfig.fault_rate / --fault- '
    "rate: a float in [0, 1]; ''/unset = the config field. Injections "
    'count in engine.faults.injected and land in bench JSON as the '
    "'faults' block.",
)

_register(
    "BCG_TPU_CHECKPOINT_DIR", "str", None,
    "Root directory searched for local safetensors checkpoints "
    "(models/loader.find_checkpoint_dir).",
)

# BCG_TPU_TRACE* — span tracer / observability (bcg_tpu_torch/obs).
_register(
    "BCG_TPU_TRACE", "bool", False,
    "Enable the span tracer (bcg_tpu_torch/obs): orchestrator and engine "
    "spans are ring-buffered and exportable as Chrome trace-event JSON "
    "(Perfetto).",
)
_register(
    "BCG_TPU_TRACE_OUT", "str", None,
    "Path the tracer exports its Chrome trace JSON to at process exit "
    "(setting it implies BCG_TPU_TRACE).",
)
_register(
    "BCG_TPU_TRACE_RING", "int", 65536,
    "Span-event ring-buffer capacity; the oldest events are evicted "
    "beyond it (the summarize() latency table is NOT subject to "
    "eviction).",
)
_register(
    "BCG_TPU_COMPILE_OBS", "str", None,
    "Compile-cost observability (bcg_tpu_torch/obs/compile.py): per-entry "
    "first-call and nvcc build time histograms (engine.compile_ms.*), "
    "first-compile vs retrace split, shape-cache population gauges, and "
    "a structured cause record per new shape of a shape-keyed seam "
    "(engine.retrace_cause.* — which argument changed, e.g. batch "
    "8->16).  '1' = counters only; any other value = counters plus the "
    "cause JSONL stream appended at that path (first line = run "
    "manifest).  Off: zero surface — nothing registered, no threads.",
)
_register(
    "BCG_TPU_PROFILE", "str", None,
    "Profiler capture window: wrap the BCG_TPU_PROFILE_ROUNDS-selected "
    "orchestrator rounds in one bounded torch.profiler trace written "
    "into this directory as trace.json (Perfetto-loadable; "
    "manifest.json stamps the fleet identity).",
)
_register(
    "BCG_TPU_PROFILE_ROUNDS", "str", "1-2",
    "Inclusive 1-based 'a-b' window of rounds/dispatches the "
    "BCG_TPU_PROFILE capture wraps (a bare 'a' captures one); the "
    "first stream to reach 'a' owns the window.",
)
_register(
    "BCG_TPU_HOSTSYNC", "bool", False,
    "Runtime host-sync auditor (bcg_tpu_torch/obs/hostsync.py): count "
    "every device->host synchronization at the instrumented decode-path "
    "seams (prefill barrier, decode/steps/spec readbacks, the done "
    "poll), plus, on a CUDA card, every other synchronizing operation "
    "(torch.cuda.set_sync_debug_mode), attributed to the active tracer "
    "span or loop entry — engine.hostsync.* counters and the "
    "game.host_syncs per-round histogram.  Off: zero surface — nothing "
    "registered, nothing intercepted.",
)
_register(
    "BCG_TPU_HLO_CENSUS", "bool", False,
    "Record a per-decode-step launch census at each decode loop's first "
    "call (bcg_tpu_torch/obs/hlo.py): the kernel-wrapper calls and "
    "launches of one step by kind and, on CUDA, the card's kernels of "
    "that step by kind from torch.profiler, published as engine.hlo.* "
    "gauges (one profiled step per loop entry — keep off on serving hot "
    "paths).",
)
_register(
    "BCG_TPU_METRICS_PORT", "int", 0,
    "Serve the counter/gauge registry as a Prometheus text exposition "
    "on http://127.0.0.1:<port>/metrics (stdlib HTTP server, daemon "
    "thread; 0 = disabled).",
)
_register(
    "BCG_TPU_SERVE_EVENTS", "str", None,
    "Append serve-path request lifecycle events (admitted/dispatched/"
    "completed/rejected, with request id and latency breakdown) as "
    "JSONL to this path (first line = run manifest).",
)
_register(
    "BCG_TPU_GAME_EVENTS", "str", None,
    "Append per-round consensus-game events (round start/end, agent "
    "decisions, topology-masked deliveries, votes, convergence "
    "metrics) as JSONL to this path (first line = run manifest).",
)
# BCG_TPU_FLEET* / RUN_ID / METRICS_SHARD* — distributed observability
# plane (bcg_tpu_torch/obs/fleet.py).
_register(
    "BCG_TPU_FLEET", "bool", False,
    "Force fleet identity stamping on (Prometheus process=/host= "
    "labels, fleet.* gauges) even in a single-process run; stamping "
    "also engages automatically under a shard dir.  Off (the default, "
    "single-process): the exposition is byte-identical to the "
    "unstamped form.",
)
_register(
    "BCG_TPU_RUN_ID", "str", None,
    "Run id shared by every rank of one fleet run (shard file names, "
    "JSONL run manifests, fleet report merge key); unset = a stable "
    "per-process 12-hex id.",
)
_register(
    "BCG_TPU_METRICS_SHARD_DIR", "str", None,
    "Directory the per-process metric-shard flusher appends "
    "shard-<run_id>-<process>.jsonl typed counter/gauge/histogram "
    "snapshots into (counters sum, histograms bucket-wise, gauges "
    "per-rank when merged).",
)
_register(
    "BCG_TPU_METRICS_SHARD_MS", "int", 1000,
    "Metric-shard flush (and heartbeat) period in milliseconds.",
)
_register(
    "BCG_TPU_FLEET_STRAGGLER_FACTOR", "int", 3,
    "Straggler lag factor: a rank is flagged when its watermark is "
    "under median/factor or its heartbeat is older than factor x the "
    "flush period (fleet.stragglers gauge); 0 disables detection.",
)
# BCG_TPU_ALERT* — health & alerting plane (bcg_tpu_torch/obs/alerts.py).
_register(
    "BCG_TPU_ALERTS", "bool", False,
    "Rule-driven alert engine (bcg_tpu_torch/obs/alerts.py): a periodic "
    "evaluator thread checks the default ruleset (SLO burn-rate, "
    "engine-error/retrace storms, pool-headroom floor, heartbeat "
    "staleness, ...) against ONE registry snapshot per cycle, counts "
    "firing/resolved transitions under alert.*, exports "
    "alert_firing{rule=...} on the Prometheus exposition, and feeds "
    "the /healthz page-severity verdict.  Off: zero surface — nothing "
    "registered, no threads.",
)
_register(
    "BCG_TPU_ALERT_MS", "int", 1000,
    "Alert-rule evaluation period in milliseconds (delta-rate and "
    "burn-rate rules measure per-window deltas at this cadence).",
)
_register(
    "BCG_TPU_ALERT_EVENTS", "str", None,
    "Append alert firing/resolved transition events as JSONL to this "
    "path (first line = run manifest).",
)
# BCG_TPU_CHAOS — chaos injection (runtime/resilience.py) at the
# scheduler's and the engine's seams.
_register(
    "BCG_TPU_CHAOS", "str", None,
    "Seeded chaos plan over the instrumented fault seams "
    "(runtime/resilience.py): ';'-separated "
    "'<kind>@<site>:<when>[:<arg>]' directives (kinds crash/hang/"
    "exhaust/diskfail/freeze; sites serve.dispatch, engine.generate, "
    "kvpool.alloc, sink.write, sweep.job, fleet.heartbeat; when = "
    "occurrence list, 'n+', or 'p<rate>') plus an optional 'seed=<n>'. "
    "Unset = zero surface.",
)
# BCG_TPU_SERVE* / SWEEP* / FAULT_SEED / COLLECTIVE_WATCHDOG_S — the
# serving, sweep and fault-injection tiers (serve/, sweep/,
# engine/{fault,collective}.py), as the JAX package registers them.
_register(
    "BCG_TPU_SERVE", "bool", False,
    "Route concurrent games through the arrival-driven ServingEngine "
    "scheduler (bcg_tpu_torch/serve) instead of the CollectiveEngine lockstep "
    "barrier.",
)
_register(
    "BCG_TPU_SERVE_LINGER_MS", "int", 10,
    "Max milliseconds a partial device batch lingers for merge partners "
    "before the scheduler dispatches it anyway (0 = dispatch "
    "immediately).",
)
_register(
    "BCG_TPU_SERVE_BUCKET_ROWS", "int", 0,
    "Explicit device-batch row bucket for the serving scheduler; also "
    "enables strict admission (oversize requests rejected).  0 derives "
    "the merge cap from the engine's KV budget (cap_for) instead.",
)
_register(
    "BCG_TPU_SERVE_MAX_QUEUE_ROWS", "int", 4096,
    "Backpressure watermark: submissions block while the scheduler "
    "queue holds at least this many rows.",
)
_register(
    "BCG_TPU_SERVE_DEADLINE_MS", "int", 0,
    "Per-request deadline for serving-scheduler calls; a request still "
    "queued past it fails with RequestCancelled (0 = no deadline).",
)
_register(
    "BCG_TPU_SERVE_SLO_MS", "int", 0,
    "Serving latency objective in milliseconds: each completed "
    "request's submit-to-complete latency is compared against it, "
    "feeding the serve.slo.violations counter and the "
    "serve.slo.headroom_ms histogram (0 = no SLO tracking).",
)
_register(
    "BCG_TPU_SERVE_MAX_DISPATCH_RETRIES", "int", 0,
    "Serving-scheduler dispatch retry budget: a failed device batch is "
    "retried up to N times with capped exponential backoff + jitter, "
    "then bisected to isolate poison requests before per-request "
    "failure (serve.dispatch_retries / serve.batch_splits / "
    "serve.recoveries counters; 0 = fail the batch on first error, the "
    "pre-recovery behaviour).",
)
_register(
    "BCG_TPU_SERVE_WATCHDOG_S", "int", 0,
    "Device-call hang watchdog for the serving scheduler, in seconds: "
    "a dispatch exceeding it is declared hung and the engine supervisor "
    "rebuilds the engine ONCE (when the scheduler was given an "
    "engine_factory) before declaring the scheduler dead; 0 = off "
    "(dispatches run inline with no timeout).",
)
_register(
    "BCG_TPU_SERVE_DEFER_WAIT_S", "int", 600,
    "Total-wait ceiling for a tenant's quota-deferral backoff loop "
    "(serve/engine.py): cumulative jittered retry-after sleeps past it "
    "surface SchedulerClosed instead of spinning on a wedged scheduler "
    "forever; 0 = no ceiling.",
)
_register(
    "BCG_TPU_SWEEP_DIR", "str", None,
    "Default output directory for `python -m bcg_tpu_torch.sweep run` (the "
    "sweep manifest, per-rank game-event files, and per-job round "
    "checkpoints land here; --out overrides).  Unset = "
    "./sweeps/<spec name>.",
)
_register(
    "BCG_TPU_SWEEP_MAX_CONCURRENT", "int", 4,
    "Games in flight at once per rank in a sweep (worker threads over "
    "the rank's job partition); each game is a tenant of the shared "
    "serving scheduler, so this bounds tenant concurrency, not batch "
    "size.",
)
_register(
    "BCG_TPU_SWEEP_TENANT_QUOTA_ROWS", "int", 0,
    "Per-tenant queued-row quota on the sweep's shared scheduler: a "
    "tenant submitting past it is deferred with an SLO-headroom-"
    "derived retry-after (AdmissionDeferred) instead of hard-rejected; "
    "0 = unlimited.",
)
_register(
    "BCG_TPU_SWEEP_MAX_JOB_RETRIES", "int", 0,
    "Sweep job retry budget: a job whose failure classifies as "
    "TRANSIENT (runtime/resilience.classify_failure — injected chaos, "
    "pool exhaustion, timeouts, I/O flakes) is requeued up to N times "
    "with backoff, resuming from its newest round checkpoint "
    "(sweep.jobs.retried counter; permanent failures never retry; "
    "0 = every failure is terminal, the pre-recovery behaviour).",
)
_register(
    "BCG_TPU_FAULT_SEED", "int", 0,
    "Seed for FaultInjectingEngine's corruption RNG, overriding "
    "EngineConfig.fault_seed / --fault-seed (only read when a fault "
    "rate is in effect).",
)
_register(
    "BCG_TPU_COLLECTIVE_WATCHDOG_S", "int", 0,
    "Collective-barrier watchdog period in seconds: force-retire "
    "participants whose worker thread died without retire() so the "
    "barrier cannot hang (0 = off).",
)

# -------------------------------------------------------------- accessors
def _lookup(name: str) -> EnvFlag:
    flag = REGISTRY.get(name)
    if flag is None:
        raise KeyError(
            f"env flag {name!r} is not registered in "
            f"bcg_tpu_torch.runtime.envflags — add it to the registry"
        )
    return flag


def parse_bool(raw: Optional[str], default: bool = False) -> bool:
    """ONE boolean parse for the whole package: unset/empty -> default;
    '0'/'false'/'no'/'off' (case/whitespace-insensitive) -> False;
    anything else -> True."""
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in _FALSY


def is_set(name: str) -> bool:
    """True when the (registered) flag is present in the environment at
    all — for call sites whose default depends on other state."""
    return os.environ.get(_lookup(name).name) is not None


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    """Boolean flag value; ``default`` overrides the registered default
    (for size-class-dependent call sites)."""
    flag = _lookup(name)
    if flag.kind != "bool":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not bool")
    fallback = flag.default if default is None else default
    return parse_bool(os.environ.get(name), bool(fallback))


def get_int(name: str, default: Optional[int] = None) -> int:
    """Integer flag value; unset/empty -> default; unparseable -> default
    with a LOUD stderr warning (silently recording a run under the wrong
    window/rounds config would be worse than either crashing or
    defaulting)."""
    flag = _lookup(name)
    if flag.kind != "int":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not int")
    fallback = int(flag.default if default is None else default)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return fallback
    try:
        return int(raw)
    except ValueError:
        import sys

        print(
            f"envflags: {name}={raw!r} is not an integer — using "
            f"{fallback}",
            file=sys.stderr,
        )
        return fallback


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String flag value; unset -> default (which may be None)."""
    flag = _lookup(name)
    if flag.kind != "str":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not str")
    fallback = flag.default if default is None else default
    raw = os.environ.get(name)
    return fallback if raw is None else raw


def overrides() -> Dict[str, str]:
    """Raw values of every REGISTERED flag present in the environment —
    the run-manifest form (JSONL sink headers record exactly what was
    overridden, so sweep-level grouping is mechanical).  Raw strings,
    not parsed values: a manifest must round-trip what the operator set,
    and the registry accessors cannot represent "was unset"."""
    out = {}
    for name in REGISTRY:
        raw = os.environ.get(name)
        if raw is not None:
            out[name] = raw
    return dict(sorted(out.items()))


# ------------------------------------------------------------------ docs
def markdown_table() -> str:
    """Registry as a README-ready markdown table."""
    lines = [
        "| Flag | Type | Default | Meaning |",
        "| --- | --- | --- | --- |",
    ]
    for flag in REGISTRY.values():
        default = "(unset)" if flag.default is None else repr(flag.default)
        lines.append(
            f"| `{flag.name}` | {flag.kind} | `{default}` | {flag.doc} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table())
