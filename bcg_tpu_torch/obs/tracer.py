"""Span tracer: nestable, cross-thread spans → Chrome trace-event JSON.

The serving stack's latency is spread over threads — a game thread
builds prompts and blocks on its request future, the scheduler thread
forms batches and runs the device — so a slow round could be queue
wait, a retrace, or a KV-admission stall and per-phase wall-clock sums
cannot say which.  Spans can: every instrumented layer opens named
spans (``round`` → ``decide`` → ``serve.request`` → … →
``engine.decode``), events land in a bounded ring buffer, and
``export()`` writes Chrome trace-event JSON loadable in Perfetto
(ui.perfetto.dev) with per-thread nesting intact.

Mechanics:

* **Nesting** is thread-local: a span's parent defaults to the top of
  the CURRENT thread's open-span stack.
* **Cross-thread parent handoff** is explicit: a layer that carries
  work across threads stashes the originating span handle (e.g.
  ``Request.span`` in ``bcg_tpu/serve/scheduler.py``) and passes it as
  ``parent=`` when it resumes on the other thread; the exported events
  carry ``span_id``/``parent_id`` in ``args`` so the lineage survives
  the thread boundary (Perfetto still nests per-thread; the ids are the
  ground truth for tools and tests).
* **B/E pairs** come from the ``span()`` context manager and are always
  balanced (the exit records in a ``finally``); ``complete()`` records
  an already-measured interval as a single ``X`` (complete) event —
  used where an interval's endpoints live on different threads (a
  request's enqueue→dispatch ``queue_wait``).
* **Ring buffer**: the event deque holds the last
  ``BCG_TPU_TRACE_RING`` events; a long run keeps its tail, and the
  per-name latency accumulator (:class:`SpanAggregator`) is NOT subject
  to eviction, so ``summarize()`` covers the whole run.

Enablement: ``BCG_TPU_TRACE=1`` (or setting ``BCG_TPU_TRACE_OUT``,
which also registers an atexit export to that path).  Flags are read
ONCE at first use — a per-span env read would be measurable overhead on
hot paths; tests reconfigure via :func:`reset`.  When disabled, the
module-level :func:`span` returns a shared no-op context manager whose
cost is bounded by test (``tests/test_obs.py`` disabled-overhead
bound); call sites therefore never need their own ``if traced:`` guard.

No jax import — loadable by flag-only consumers (bench.py error path).
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from bcg_tpu_torch.obs import counters as _counters
from bcg_tpu_torch.runtime import envflags

# Bounded per-name duration reservoir for p50/p95 (newest-biased: a
# steady-state regression shows up; exact quantiles over unbounded
# history would grow without bound on long serving runs).
_SAMPLE_CAP = 512


def percentile(sorted_samples: List[float], q: float) -> float:
    """Nearest-rank percentile over an ascending-sorted list."""
    if not sorted_samples:
        return 0.0
    idx = max(0, min(len(sorted_samples) - 1,
                     int(round(q * (len(sorted_samples) - 1)))))
    return sorted_samples[idx]


class SpanAggregator:
    """Per-name latency accumulator: count/total plus a bounded sample
    reservoir for p50/p95.  Shared by :meth:`Tracer.summarize`, the
    ``SimulationProfiler`` (which delegates its phase timing here), and
    the serve scheduler's per-stage ``latency_ms`` snapshot — one
    aggregation implementation, three consumers."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> [count, total_seconds, deque(samples)]
        self._stats: Dict[str, list] = {}

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = [0, 0.0, deque(maxlen=_SAMPLE_CAP)]
            st[0] += 1
            st[1] += seconds
            st[2].append(seconds)

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return {n: st[0] for n, st in self._stats.items()}

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return {n: st[1] for n, st in self._stats.items()}

    def table(self) -> Dict[str, Dict[str, float]]:
        """{name: {count, total_ms, mean_ms, p50_ms, p95_ms}}, sorted
        by total descending (the hot row first)."""
        with self._lock:
            rows = {}
            for name, (count, total, samples) in self._stats.items():
                ordered = sorted(samples)
                rows[name] = {
                    "count": count,
                    "total_ms": round(total * 1e3, 3),
                    "mean_ms": round(total * 1e3 / count, 3) if count else 0.0,
                    "p50_ms": round(percentile(ordered, 0.50) * 1e3, 3),
                    "p95_ms": round(percentile(ordered, 0.95) * 1e3, 3),
                }
        return dict(
            sorted(rows.items(), key=lambda kv: -kv[1]["total_ms"])
        )


class SpanHandle:
    """Identity of one open (or finished) span — what cross-thread
    callers pass as ``parent=``."""

    __slots__ = ("name", "span_id", "parent_id", "tid")

    def __init__(self, name: str, span_id: int, parent_id: Optional[int],
                 tid: int):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _TimedOnly:
    """Times the block and feeds a :class:`SpanAggregator`, recording no
    events — what ``span(aggregate=...)`` degrades to when tracing is
    off (the profiler's phase timing must keep working untraced: it
    feeds the metrics CSV)."""

    __slots__ = ("_agg", "_name", "_t0")

    def __init__(self, agg: SpanAggregator, name: str):
        self._agg = agg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return None

    def __exit__(self, exc_type, exc, tb):
        self._agg.add(self._name, time.perf_counter() - self._t0)
        return False


class _SpanCm:
    """Context manager for one traced span (B event on enter, E on
    exit — the exit runs unconditionally, so B/E stay balanced even
    when the body raises)."""

    __slots__ = ("_tracer", "_name", "_parent", "_args", "_aggregate",
                 "_handle", "_t0")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional[SpanHandle], args: Optional[Dict],
                 aggregate: Optional[SpanAggregator]):
        self._tracer = tracer
        self._name = name
        self._parent = parent
        self._args = args
        self._aggregate = aggregate

    def __enter__(self) -> SpanHandle:
        self._t0 = time.perf_counter()
        self._handle = self._tracer._begin(
            self._name, self._parent, self._args, self._t0
        )
        return self._handle

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        self._tracer._end(self._handle, t1, failed=exc_type is not None)
        seconds = t1 - self._t0
        if self._aggregate is not None:
            self._aggregate.add(self._name, seconds)
        self._tracer._agg.add(self._name, seconds)
        return False


class Tracer:
    """Thread-safe span recorder over a bounded event ring."""

    def __init__(self, ring_capacity: int = 65536):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=max(16, int(ring_capacity)))
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._agg = SpanAggregator()
        self._thread_names: Dict[int, str] = {}

    # ------------------------------------------------------------- recording

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[SpanHandle]:
        """Top of the calling thread's open-span stack (None outside any
        span) — what layers stash for cross-thread parent handoff."""
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def _note_thread(self, tid: int) -> None:
        if tid not in self._thread_names:
            self._thread_names[tid] = threading.current_thread().name

    def _begin(self, name: str, parent: Optional[SpanHandle],
               args: Optional[Dict], t0: float) -> SpanHandle:
        tid = threading.get_ident()
        stack = self._stack()
        if parent is None and stack:
            parent = stack[-1]
        handle = SpanHandle(
            name, next(self._ids),
            parent.span_id if parent is not None else None, tid,
        )
        stack.append(handle)
        ts = (t0 - self._epoch) * 1e6
        with self._lock:
            self._note_thread(tid)
            self._events.append(
                ("B", name, ts, tid, handle.span_id, handle.parent_id,
                 dict(args) if args else None, None)
            )
        return handle

    def _end(self, handle: SpanHandle, t1: float, failed: bool = False) -> None:
        stack = self._stack()
        # Pop down to (and including) this handle: a body that leaked an
        # unclosed child must not corrupt the stack for later spans.
        while stack and stack[-1] is not handle:
            stack.pop()
        if stack:
            stack.pop()
        ts = (t1 - self._epoch) * 1e6
        with self._lock:
            self._events.append(
                ("E", handle.name, ts, handle.tid, handle.span_id, None,
                 {"failed": True} if failed else None, None)
            )

    def span(self, name: str, parent: Optional[SpanHandle] = None,
             args: Optional[Dict] = None,
             aggregate: Optional[SpanAggregator] = None) -> _SpanCm:
        return _SpanCm(self, name, parent, args, aggregate)

    def complete(self, name: str, seconds: float,
                 parent: Optional[SpanHandle] = None,
                 args: Optional[Dict] = None) -> None:
        """Record an already-measured interval ending NOW as one ``X``
        event (for intervals whose start lived on another thread —
        enqueue→dispatch waits)."""
        tid = threading.get_ident()
        end = time.perf_counter()
        ts = (end - seconds - self._epoch) * 1e6
        with self._lock:
            self._note_thread(tid)
            self._events.append(
                ("X", name, ts, tid, next(self._ids),
                 parent.span_id if parent is not None else None,
                 dict(args) if args else None, seconds * 1e6)
            )
        self._agg.add(name, seconds)

    # --------------------------------------------------------------- reading

    def events(self) -> List[Tuple]:
        with self._lock:
            return list(self._events)

    def summarize(self) -> Dict[str, Dict[str, float]]:
        """Per-span-name latency table (count/total/p50/p95) over the
        WHOLE run — the aggregator is not subject to ring eviction."""
        return self._agg.table()

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable).  ``ts`` is µs
        since tracer epoch; ``args.span_id``/``args.parent_id`` carry
        the explicit lineage; counters ride in ``otherData`` so one file
        holds the full observability state."""
        with self._lock:
            events = list(self._events)
            threads = dict(self._thread_names)
        pid = os.getpid()
        trace_events: List[Dict[str, Any]] = [
            {
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": tname},
            }
            for tid, tname in sorted(threads.items())
        ]
        for ph, name, ts, tid, span_id, parent_id, args, dur in events:
            ev: Dict[str, Any] = {
                "name": name, "cat": "bcg", "ph": ph,
                "ts": round(ts, 3), "pid": pid, "tid": tid,
                "args": {"span_id": span_id},
            }
            if parent_id is not None:
                ev["args"]["parent_id"] = parent_id
            if args:
                ev["args"].update(args)
            if dur is not None:
                ev["dur"] = round(dur, 3)
            trace_events.append(ev)
        data = {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {
                "counters": _counters.snapshot(),
                "span_summary": self.summarize(),
            },
        }
        # Fleet identity (run id, rank, host) so traces from many ranks
        # of one run stay attributable after they are copied off-host.
        from bcg_tpu_torch.obs import fleet as _fleet

        if _fleet.enabled():
            data["otherData"]["fleet"] = _fleet.identity()
        if path:
            with open(path, "w") as f:
                json.dump(data, f)
        return data


# ---------------------------------------------------------- module surface
_config_lock = threading.Lock()
_tracer: Optional[Tracer] = None
_configured = False


def _ensure() -> Optional[Tracer]:
    global _tracer, _configured
    if _configured:
        return _tracer
    with _config_lock:
        if not _configured:
            out = envflags.get_str("BCG_TPU_TRACE_OUT")
            enabled = envflags.get_bool("BCG_TPU_TRACE") or bool(out)
            if enabled:
                _tracer = Tracer(envflags.get_int("BCG_TPU_TRACE_RING"))
                if out:
                    atexit.register(flush)
            _configured = True
    return _tracer


def get_tracer() -> Optional[Tracer]:
    """The active tracer, or None when tracing is disabled."""
    return _ensure()


def enabled() -> bool:
    return _ensure() is not None


def span(name: str, parent: Optional[SpanHandle] = None,
         args: Optional[Dict] = None,
         aggregate: Optional[SpanAggregator] = None):
    """Open a span on the active tracer; no-op (shared singleton) when
    tracing is disabled — unless ``aggregate`` is given, in which case
    the block is still timed into the aggregate (profiler semantics)."""
    t = _tracer if _configured else _ensure()
    if t is not None:
        return t.span(name, parent=parent, args=args, aggregate=aggregate)
    if aggregate is not None:
        return _TimedOnly(aggregate, name)
    return _NULL_SPAN


def current() -> Optional[SpanHandle]:
    """Calling thread's innermost open span (None when disabled/none)."""
    t = _tracer if _configured else _ensure()
    return t.current() if t is not None else None


def complete(name: str, seconds: float,
             parent: Optional[SpanHandle] = None,
             args: Optional[Dict] = None) -> None:
    t = _tracer if _configured else _ensure()
    if t is not None:
        t.complete(name, seconds, parent=parent, args=args)


def summarize() -> Optional[Dict[str, Dict[str, float]]]:
    t = _tracer if _configured else _ensure()
    return t.summarize() if t is not None else None


def flush() -> Optional[str]:
    """Export to the configured ``BCG_TPU_TRACE_OUT`` path (atexit hook;
    also callable directly).  Returns the path written, or None."""
    t = _tracer if _configured else _ensure()
    out = envflags.get_str("BCG_TPU_TRACE_OUT")
    if t is None or not out:
        return None
    t.export(out)
    return out


def reset() -> None:
    """Drop the cached tracer AND its read-once flag cache so the next
    use re-reads the environment — TEST-ONLY."""
    global _tracer, _configured
    with _config_lock:
        _tracer = None
        _configured = False
