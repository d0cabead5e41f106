"""Compile-cost observability (``BCG_TPU_COMPILE_OBS``) + profiler
capture windows (``BCG_TPU_PROFILE`` / ``BCG_TPU_PROFILE_ROUNDS``) — the
port of ``bcg_tpu/obs/compile.py``.

The PyTorch engine runs eagerly: nothing is traced per shape.  What a
new shape costs it is paid at the port's shape-keyed seams, and those
feed the same records as the JAX package's trace-cache misses:

* **Signature events** (:func:`note_shape`, keeping each entry's seen
  signatures): a new padded batch (the engine's ``pad_batch`` entry:
  plan queries and workspaces of the new shape are paid by its first
  call), the growth of the split-attention workspace
  (``split_workspace``), a miss of the guided sampler's per-shape launch
  plan cache (``sampler_plan``), and each first-use ``nvcc`` build of a
  kernel library (``nvcc_<library>``; builds run side by side, so each
  is charged the wall time since the previous one finished, and a
  batch's charges add up to its wall time).  Each new signature counts
  ``engine.compile.<entry>``, as a trace-cache miss does in the JAX
  engine.  A first signature is a ``first_compile``; any later one is
  a ``retrace`` (``engine.retrace.<entry>``) that emits exactly ONE
  structured cause record: which argument changed (``batch 8→16``),
  classified into the cause taxonomy
  (``shape`` / ``dtype`` / ``static_knob`` / ``path`` / ``arity``) —
  ``engine.retrace_cause.<kind>`` counters plus a JSONL event through
  the bounded :class:`~bcg_tpu_torch.obs.export.EventSink` when the flag
  value is a path.  Cause records are attributed span-first (the
  innermost open tracer span), then entry (``jit_<entry>``).
* **First-call timings.**  The seams wrap their first calls in
  :func:`time_block`; a block whose entry has a pending signature event
  (``timing="pending"``: noted before the call) or whose elapsed the
  immediately following note consumes (``timing="stash"``: noted after)
  records its wall time into the per-entry ``engine.compile_ms.<entry>``
  histogram, split into the cumulative
  ``engine.compile_obs.first_compile_ms`` / ``.retrace_ms`` counters.
* **Cache gauges.**  ``engine.compile_obs.cache_entries`` counts every
  distinct (entry, signature) the observer has seen.

Profiler capture windows: ``BCG_TPU_PROFILE=<dir>`` +
``BCG_TPU_PROFILE_ROUNDS=a-b`` wrap a ``torch.profiler`` capture (CPU,
plus CUDA on a card) around orchestrator rounds ``a..b`` (or serve
dispatches, :func:`profile_dispatch`) — ONE bounded
window per process, exported as ``<dir>/trace.json`` (Chrome trace
format, Perfetto-loadable) with a ``manifest.json`` stamped with the
fleet identity (:func:`bcg_tpu_torch.obs.export.run_manifest`).  The
first round stream to reach ``a`` owns the window; it closes after
``b`` (or at interpreter exit, so a short run never leaves the profiler
running).

Zero surface when off: flags are read ONCE at first use, nothing is
registered, no threads start, and every module entry point degrades to
a shared no-op.  No torch import at module scope; torch is touched only
inside the profiler window, and only when it actually starts.
"""

from __future__ import annotations

import re
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.obs import tracer as obs_tracer
from bcg_tpu_torch.runtime import envflags

# Attribution fragments must stay inside the metric-name taxonomy
# (BCG-OBS-NAME): span names like ``serve.request`` flatten to
# ``serve_request`` (the hostsync sanitizer).
_SANITIZE_RE = re.compile(r"[^a-z0-9_]")

# Per-entry compile-time histogram bounds (milliseconds).  The ladder
# resolves both the tiny-test CPU gate's sub-second compiles and a
# remote 8B boot's minutes-scale first compile.
COMPILE_MS_BOUNDS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0,
    5000.0, 10000.0, 30000.0, 60000.0, 120000.0,
)

# The cause taxonomy (DESIGN.md "Compile observability").  Every
# counted retrace carries exactly one primary cause from this set.
CAUSE_KINDS = ("shape", "dtype", "static_knob", "path", "arity")

# Signature argument names classified as static knobs: python-level
# loop-builder parameters, not array shapes.  A numeric delta in any
# OTHER argument (batch, window, cache length) is a shape change.
_KNOB_NAMES = frozenset(
    {"max_new", "top_p", "spec_k", "spec_ngram", "attn_impl",
     "sampler_impl"}
)
_DTYPE_RE = re.compile(
    r"^(bf16|bfloat16|f16|float16|f32|float32|f64|float64|int4|int8|"
    r"int16|int32|int64|uint8|bool)$"
)

# Bounded in-memory cause-record window (the LAST_COMPILE_OBS /
# test-assertion surface; the JSONL sink carries the unbounded stream).
CAUSE_RING = 256


def _sanitize(name: str) -> str:
    return _SANITIZE_RE.sub("_", name.lower())


class _NullCm:
    """Shared no-op context manager — the disabled fast path (the
    hostsync ``_NullEntry`` idiom)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_CM = _NullCm()


# ------------------------------------------------------- signature diffing
def _classify_delta(name: str, old: Any, new: Any) -> str:
    """Primary cause kind for one changed signature argument."""
    if name == "path":
        return "path"
    if (isinstance(old, str) and isinstance(new, str)
            and (_DTYPE_RE.match(old) or _DTYPE_RE.match(new))):
        return "dtype"
    if name in _KNOB_NAMES:
        return "static_knob"
    if isinstance(old, tuple) and isinstance(new, tuple):
        if len(old) != len(new):
            return "shape"
        for o, n in zip(old, new):
            if o != n:
                return _classify_delta(name, o, n)
        return "shape"
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return "shape"
    return "static_knob"


def _arg_name(index: int, names: Optional[Sequence[str]]) -> str:
    if names is not None and index < len(names):
        return names[index]
    return f"arg{index}"


def diff_signature(
    sig: Tuple, prior: Sequence[Tuple],
    names: Optional[Sequence[str]] = None,
) -> Dict[str, Any]:
    """One structured cause for a retraced signature: the NEAREST prior
    signature (same arity, fewest differing positions, most recent on
    ties — ``prior`` is in insertion order) diffed arg-by-arg.  Returns
    ``{"cause", "arg", "old", "new", "changed": [...]}`` where ``arg``/
    ``old``/``new`` describe the PRIMARY (first) differing argument and
    ``changed`` lists every differing argument name.  No same-arity
    prior ⇒ cause ``arity`` (the signature tuple itself changed shape,
    e.g. a prefill path switch between the 4- and 5-tuple forms)."""
    same_arity = [p for p in prior if len(p) == len(sig)]
    if not same_arity:
        nearest = prior[-1]
        return {
            "cause": "arity",
            "arg": "signature",
            "old": len(nearest),
            "new": len(sig),
            "changed": ["signature"],
        }
    best: Optional[Tuple] = None
    best_diffs: List[int] = []
    for cand in same_arity:  # later wins ties: <= keeps the most recent
        diffs = [i for i, (o, n) in enumerate(zip(cand, sig)) if o != n]
        if best is None or len(diffs) <= len(best_diffs):
            best, best_diffs = cand, diffs
    if not best_diffs:  # defensive: caller only diffs genuinely new sigs
        return {"cause": "static_knob", "arg": "signature",
                "old": None, "new": None, "changed": []}
    i = best_diffs[0]
    return {
        "cause": _classify_delta(_arg_name(i, names), best[i], sig[i]),
        "arg": _arg_name(i, names),
        "old": best[i],
        "new": sig[i],
        "changed": [_arg_name(j, names) for j in best_diffs],
    }


def _jsonable(value: Any) -> Any:
    """Signature elements as JSONL-safe values (tuples render as their
    repr — a grammar signature is an opaque key, not data)."""
    if isinstance(value, (int, float, str, bool)) or value is None:
        return value
    return repr(value)


class CompileObserver:
    """Process-wide compile recorder; one instance per enabled process
    (module surface below).  All mutation goes through the counter
    registry, so snapshots/deltas/exposition ride the established
    machinery for free."""

    def __init__(self, events_path: Optional[str] = None):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._cache_entries = 0
        self._retraces = 0
        self._cause_records = 0
        self._causes: deque = deque(maxlen=CAUSE_RING)
        self._shapes: Dict[str, Dict[Tuple, bool]] = {}
        self._sink = None
        # Register the namespace at construction: an enabled-but-idle
        # process still advertises the accounting surface (and the
        # exact-bytes zero-surface test has a definite complement).
        obs_counters.counter("engine.compile_obs.first_compile_ms")
        obs_counters.counter("engine.compile_obs.retrace_ms")
        # The JAX census's ahead-of-time compile milliseconds, which the
        # report scripts read beside the other two: the port's census
        # watches a step run and compiles nothing, so it stays 0.
        obs_counters.counter("engine.compile_obs.aot_ms")
        obs_counters.gauge("engine.compile_obs.cache_entries")
        if events_path:
            from bcg_tpu_torch.obs import export as obs_export

            self._sink = obs_export.EventSink(
                events_path,
                drop_counter="engine.compile_obs.events_dropped",
                manifest=obs_export.run_manifest(kind="compile"),
            )

    # ------------------------------------------------------------ recording

    def _pending(self) -> Dict[str, str]:
        pend = getattr(self._local, "pending", None)
        if pend is None:
            pend = self._local.pending = {}
        return pend

    def _stash(self) -> Dict[str, float]:
        stash = getattr(self._local, "stash", None)
        if stash is None:
            stash = self._local.stash = {}
        return stash

    def note_signature(
        self, entry: str, sig: Tuple, prior: Sequence[Tuple],
        names: Optional[Sequence[str]] = None,
        timing: str = "pending",
    ) -> None:
        """Record one trace-cache miss: ``sig`` is NEW for ``entry``
        (the caller's cache already established that), ``prior`` are the
        entry's earlier signatures in insertion order.  First signature
        per entry = first compile; later ones = retraces, each emitting
        exactly one structured cause record.

        ``timing`` declares the seam's note/dispatch ordering, which is
        a property of the CALL SITE, never inferred: ``"stash"`` = the
        note follows its timed dispatch on the same thread (prefill),
        so the block's just-written stash IS this miss's duration;
        ``"pending"`` = the note precedes the first invocation (the
        decode-loop builders), so a pending marker is left for the next
        block's exit — and any stale stash from an earlier STEADY-STATE
        dispatch of this entry is DISCARDED, not consumed (consuming it
        recorded the previous warm call's execute time as the retrace's
        compile time)."""
        first = not prior
        kind = "first_compile" if first else "retrace"
        with self._lock:
            self._cache_entries += 1
            entries = self._cache_entries
        obs_counters.set_gauge("engine.compile_obs.cache_entries", entries)
        # The JAX engine's trace-cache counters, which the report scripts
        # read beside the compile-time histograms: every new signature,
        # and each one after the first.
        obs_counters.inc(f"engine.compile.{entry}")
        if not first:
            obs_counters.inc(f"engine.retrace.{entry}")
            self._record_cause(entry, sig, prior, names)
        stash = self._stash()
        elapsed = stash.pop(entry, None)
        if timing == "stash" and elapsed is not None:
            self._record_time(entry, kind, elapsed)
        else:
            # "pending" mode reaches here with any stale steady-state
            # elapsed already popped and dropped; a "stash" seam with
            # nothing stashed (a dispatch path that skipped its
            # time_block) degrades to the pending handoff rather than
            # losing the miss.
            self._pending()[entry] = kind
        self.publish()

    def note_shape(
        self, entry: str, sig: Tuple, names: Optional[Sequence[str]] = None,
        timing: str = "pending", seconds: Optional[float] = None,
    ) -> None:
        """:meth:`note_signature` for a seam that keeps no shape cache of
        its own: ``sig`` is recorded the first time ``entry`` sees it and
        ignored after.  ``seconds``: the first call's measured duration
        when the seam timed it itself (an ``nvcc`` build)."""
        with self._lock:
            seen = self._shapes.setdefault(entry, {})
            if sig in seen:
                return
            prior = list(seen)
            seen[sig] = True
        if seconds is not None:
            self._stash()[entry] = seconds
            timing = "stash"
        self.note_signature(entry, sig, prior, names=names, timing=timing)

    def _record_cause(
        self, entry: str, sig: Tuple, prior: Sequence[Tuple],
        names: Optional[Sequence[str]],
    ) -> None:
        cause = diff_signature(sig, prior, names=names)
        span = obs_tracer.current()
        attr = (
            _sanitize(span.name) if span is not None
            else f"jit_{_sanitize(entry)}"
        )
        with self._lock:
            self._retraces += 1
            self._cause_records += 1
            record = {
                "entry": entry,
                "cause": cause["cause"],
                "arg": cause["arg"],
                "old": _jsonable(cause["old"]),
                "new": _jsonable(cause["new"]),
                "changed": cause["changed"],
                "span": attr,
            }
            self._causes.append(record)
        obs_counters.inc(f"engine.retrace_cause.{cause['cause']}")
        if self._sink is not None:
            self._sink.emit("retrace_cause", **record)

    def time_block(self, entry: str) -> "_TimeBlock":
        return _TimeBlock(self, entry)

    def _block_exit(self, entry: str, seconds: float) -> None:
        kind = self._pending().pop(entry, None)
        if kind is not None:
            self._record_time(entry, kind, seconds)
            self.publish()
        else:
            # Steady-state call: keep the elapsed around for a seam
            # that notes AFTER its dispatch (prefill); overwritten per
            # call, consumed at most once.
            self._stash()[entry] = seconds

    def _record_time(self, entry: str, kind: str, seconds: float) -> None:
        ms = seconds * 1e3
        obs_counters.histogram(
            f"engine.compile_ms.{entry}", COMPILE_MS_BOUNDS
        ).observe(ms)
        if kind == "retrace":
            obs_counters.inc("engine.compile_obs.retrace_ms", ms)
        else:
            obs_counters.inc("engine.compile_obs.first_compile_ms", ms)

    # ------------------------------------------------------------- reading

    def cause_records(self) -> List[Dict[str, Any]]:
        """Copies of the retained cause records, oldest first (bounded
        by :data:`CAUSE_RING`; the JSONL sink carries the full
        stream)."""
        with self._lock:
            return [dict(r) for r in self._causes]

    def brief(self, snap: Optional[Dict] = None) -> Dict[str, Any]:
        """The serve-snapshot block: cache population, retrace/cause
        totals, cumulative compile milliseconds by kind.  ``snap``
        lets summary() reuse its own registry snapshot instead of
        paying a second full scan per trace-cache miss."""
        if snap is None:
            snap = obs_counters.snapshot()
        causes = {
            name[len("engine.retrace_cause."):]: int(value)
            for name, value in snap.items()
            if name.startswith("engine.retrace_cause.")
        }
        with self._lock:
            entries = self._cache_entries
            retraces = self._retraces
        return {
            "cache_entries": entries,
            "retraces": retraces,
            "causes": causes,
            "first_compile_ms": round(
                float(snap.get("engine.compile_obs.first_compile_ms", 0)), 3
            ),
            "retrace_ms": round(
                float(snap.get("engine.compile_obs.retrace_ms", 0)), 3
            ),
        }

    def summary(self) -> Dict[str, Any]:
        """The bench-JSON / LAST_COMPILE_OBS form: the brief totals plus
        the per-entry compile-time table (count / total ms, rebuilt from
        the ``engine.compile_ms.<entry>`` histogram flats) and the
        retained cause records.  ONE registry snapshot feeds
        everything — publish() runs per miss, so it must not rescan the
        registry per table."""
        snap = obs_counters.snapshot()
        by_entry: Dict[str, Dict[str, float]] = {}
        for name, value in snap.items():
            if not name.startswith("engine.compile_ms."):
                continue
            rest = name[len("engine.compile_ms."):]
            if rest.endswith(".count"):
                entry = rest[: -len(".count")]
                by_entry.setdefault(entry, {})["count"] = int(value)
            elif rest.endswith(".sum"):
                entry = rest[: -len(".sum")]
                by_entry.setdefault(entry, {})["total_ms"] = round(
                    float(value), 3
                )
        out = self.brief(snap)
        out["compile_ms_by_entry"] = dict(sorted(by_entry.items()))
        out["recent_causes"] = self.cause_records()
        return out

    def publish(self) -> None:
        """Mirror the summary into ``runtime.metrics.LAST_COMPILE_OBS``
        so bench.py attaches it on success AND error paths (the
        LAST_SERVE_STATS idiom)."""
        from bcg_tpu_torch.runtime import metrics

        metrics.publish_compile_obs(self.summary())

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
            self._sink = None


class _TimeBlock:
    """Times one compile-triggering dispatch (see module docstring)."""

    __slots__ = ("_observer", "_entry", "_t0")

    def __init__(self, observer: CompileObserver, entry: str):
        self._observer = observer
        self._entry = entry

    def __enter__(self):
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._observer._block_exit(
                self._entry, time.perf_counter() - self._t0
            )
        else:
            # A failed dispatch's partial duration is not a compile
            # measurement, but its pending marker MUST come off or the
            # next successful call of this entry records a wrong kind.
            self._observer._pending().pop(self._entry, None)
        return False


# ---------------------------------------------------------- module surface
_config_lock = threading.Lock()
_observer: Optional[CompileObserver] = None
_configured = False

_TRUTHY = ("1", "true", "yes", "on")


def _parse_flag(raw: Optional[str]) -> Tuple[bool, Optional[str]]:
    """``BCG_TPU_COMPILE_OBS`` dual-mode parse: falsy/unset = off;
    a plain truthy token = counters only; anything else = counters plus
    the retrace-cause JSONL stream at that path (the BCG_TPU_XLA_CACHE
    value-or-path idiom)."""
    if raw is None:
        return False, None
    token = raw.strip()
    if not token or token.lower() in ("0", "false", "no", "off"):
        return False, None
    if token.lower() in _TRUTHY:
        return True, None
    return True, token


def _ensure() -> Optional[CompileObserver]:
    global _observer, _configured
    if _configured:
        return _observer
    with _config_lock:
        if not _configured:
            on, path = _parse_flag(
                envflags.get_str("BCG_TPU_COMPILE_OBS")
            )
            if on:
                _observer = CompileObserver(events_path=path)
            _configured = True
    return _observer


def observer() -> Optional[CompileObserver]:
    """The active observer, or None when compile observability is
    disabled."""
    return _ensure()


def enabled() -> bool:
    return _ensure() is not None


def note_signature(entry: str, sig: Tuple, prior: Sequence[Tuple],
                   names: Optional[Sequence[str]] = None,
                   timing: str = "pending") -> None:
    """Record one trace-cache miss (module-level seam API; no-op when
    disabled — call sites never need their own guard)."""
    o = _observer if _configured else _ensure()
    if o is not None:
        o.note_signature(entry, sig, prior, names=names, timing=timing)


def note_shape(entry: str, sig: Tuple, names: Optional[Sequence[str]] = None,
               timing: str = "pending", seconds: Optional[float] = None) -> None:
    """Record ``sig`` for ``entry`` if it is new (module-level seam API;
    no-op when disabled)."""
    o = _observer if _configured else _ensure()
    if o is not None:
        o.note_shape(entry, sig, names=names, timing=timing, seconds=seconds)


def time_block(entry: str):
    """Context manager timing a compile-triggering dispatch; shared
    no-op when disabled."""
    o = _observer if _configured else _ensure()
    return o.time_block(entry) if o is not None else _NULL_CM


def brief() -> Optional[Dict[str, Any]]:
    o = _observer if _configured else _ensure()
    return o.brief() if o is not None else None


def summary() -> Optional[Dict[str, Any]]:
    o = _observer if _configured else _ensure()
    return o.summary() if o is not None else None


def cause_records() -> List[Dict[str, Any]]:
    o = _observer if _configured else _ensure()
    return o.cause_records() if o is not None else []


def publish() -> None:
    o = _observer if _configured else _ensure()
    if o is not None:
        o.publish()


def reset() -> None:
    """Drop the cached observer + read-once flag caches (including the
    profiler window state) so the next use re-reads the environment —
    TEST-ONLY.  Registered ``engine.compile_obs.*`` counters persist in
    the registry (live consumers hold baselines); tests needing a
    pristine registry use a subprocess (the zero-surface pin)."""
    global _observer, _configured, _profile, _profile_configured
    global _dispatch_seq
    with _config_lock:
        if _observer is not None:
            _observer.close()
        _observer = None
        _configured = False
    with _profile_lock:
        if _profile is not None and _profile.get("active"):
            _stop_profiler(_profile)
        _profile = None
        _profile_configured = False
        _dispatch_seq = 0


# ------------------------------------------------------- profiler windows
_profile_lock = threading.Lock()
_profile: Optional[Dict[str, Any]] = None
_profile_configured = False
_dispatch_seq = 0

_ROUNDS_RE = re.compile(r"^\s*(\d+)\s*(?:-\s*(\d+)\s*)?$")


def _parse_rounds(raw: Optional[str]) -> Tuple[int, int]:
    """``a-b`` (or a bare ``a`` = one round) -> inclusive window; an
    unparseable value warns LOUDLY and falls back to the registered
    default — silently profiling the wrong rounds would be worse than
    either crashing or defaulting (the envflags.get_int contract)."""
    m = _ROUNDS_RE.match(raw or "")
    if m is None:
        import sys

        print(
            f"obs.compile: BCG_TPU_PROFILE_ROUNDS={raw!r} is not 'a-b' — "
            "using 1-2",
            file=sys.stderr,
        )
        return 1, 2
    lo = int(m.group(1))
    hi = int(m.group(2)) if m.group(2) is not None else lo
    return (lo, hi) if hi >= lo else (hi, lo)


def _profile_cfg() -> Optional[Dict[str, Any]]:
    """Read-once profiler-window config, or None when capture is off."""
    global _profile, _profile_configured
    if _profile_configured:
        return _profile
    with _profile_lock:
        if not _profile_configured:
            log_dir = envflags.get_str("BCG_TPU_PROFILE")
            if log_dir:
                lo, hi = _parse_rounds(
                    envflags.get_str("BCG_TPU_PROFILE_ROUNDS")
                )
                _profile = {
                    "dir": log_dir, "lo": lo, "hi": hi,
                    "active": False, "done": False, "owner": None,
                }
            _profile_configured = True
    return _profile


def _start_profiler(state: Dict[str, Any], kind: str) -> bool:
    """Start a ``torch.profiler`` capture (CPU, plus CUDA on a card) +
    write the window manifest; a failure marks the window done (warn
    once, never take the round down)."""
    import atexit
    import json
    import os

    try:
        import torch

        os.makedirs(state["dir"], exist_ok=True)
        from bcg_tpu_torch.obs import export as obs_export

        with open(os.path.join(state["dir"], "manifest.json"), "w") as f:
            json.dump(
                obs_export.run_manifest(
                    kind="profile", window_kind=kind,
                    first_index=state["lo"], last_index=state["hi"],
                ),
                f, indent=2, default=str,
            )
        from torch.profiler import ProfilerActivity

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
        state["prof"] = prof
        atexit.register(_atexit_stop)
        return True
    except (ImportError, OSError, RuntimeError, ValueError) as exc:
        import sys

        print(
            f"obs.compile: profiler window failed to start "
            f"({state['dir']}): {exc} — capture disabled",
            file=sys.stderr,
        )
        state["done"] = True
        return False


def _stop_profiler(state: Dict[str, Any]) -> None:
    """Stop the capture and export it as ``<dir>/trace.json``."""
    import os

    prof = state.pop("prof", None)
    try:
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(os.path.join(state["dir"], "trace.json"))
    except (OSError, RuntimeError, ValueError):
        pass
    state["active"] = False
    state["done"] = True


def _atexit_stop() -> None:
    """A run shorter than the window must not leave the profiler
    recording into a torn trace at interpreter exit."""
    with _profile_lock:
        if _profile is not None and _profile.get("active"):
            _stop_profiler(_profile)


class _ProfileCm:
    """One round/dispatch inside the capture window: starts the
    profiler when its index reaches the window floor (first stream to
    arrive owns the window), stops it after the owning stream passes
    the ceiling."""

    __slots__ = ("_kind", "_index")

    def __init__(self, kind: str, index: int):
        self._kind = kind
        self._index = index

    def __enter__(self):
        state = _profile_cfg()
        if state is None:  # reset() raced the window away
            return None
        with _profile_lock:
            if (not state["active"] and not state["done"]
                    and state["lo"] <= self._index <= state["hi"]):
                if _start_profiler(state, self._kind):  # lint: ignore[BCG-LOCK-BLOCK] one-shot start under the lock
                    state["active"] = True
                    state["owner"] = self._kind
        return None

    def __exit__(self, exc_type, exc, tb):
        state = _profile_cfg()
        if state is None:
            return False
        with _profile_lock:
            if (state["active"] and state["owner"] == self._kind
                    and self._index >= state["hi"]):
                _stop_profiler(state)
        return False


def profile_span(kind: str, index: int):
    """Context manager bounding one candidate capture unit (an
    orchestrator round, a serve dispatch) at 1-based ``index``; shared
    no-op when capture is off or the window already closed."""
    state = _profile_cfg()
    if state is None or state["done"]:
        return _NULL_CM
    return _ProfileCm(kind, index)


def profile_dispatch():
    """The serve-dispatch form of :func:`profile_span`: dispatches are
    numbered process-wide in dispatch order (the scheduler has no round
    numbers), so ``BCG_TPU_PROFILE_ROUNDS=a-b`` captures dispatches
    ``a..b``."""
    global _dispatch_seq
    state = _profile_cfg()
    if state is None or state["done"]:
        return _NULL_CM
    with _profile_lock:
        _dispatch_seq += 1
        index = _dispatch_seq
    return _ProfileCm("dispatch", index)
