"""Arrival-driven continuous-batching scheduler.

:class:`bcg_tpu_torch.engine.collective.CollectiveEngine` batches by BARRIER:
dispatch waits until every active participant is blocked, so one slow or
crashed game stalls the whole wave (and a missing ``retire()`` hangs it
forever).  :class:`Scheduler` replaces barrier semantics with a request
queue and a dispatch loop: each engine call enqueues as an independent
:class:`Request`; a single scheduler thread forms device batches whenever
a shape bucket fills **or** the oldest pending request has lingered past
``BCG_TPU_SERVE_LINGER_MS`` — it never waits on participants that are
not blocked on a call.  Games that crash simply stop submitting; their
failure reaches only their own futures.

Batch formation reuses the signature mechanics
``CollectiveEngine._dispatch_all_locked`` proved out: every guided call
shares one ``("json",)`` signature (temperature and token budget ride
PER ROW, so a game mid-decide merges with a game mid-vote); free-text
calls group by top_p.

Memory safety: the merge cap is KV-budget-aware.  When the inner engine
exposes ``cap_for`` (``engine/jax_engine.py``), the scheduler never merges
a batch past the row count the engine's HBM budget affords at the
worst-case decode window — the same accounting ``_check_kv_budget`` warns
on — so admitted concurrency cannot overcommit HBM.  A single request
larger than the cap is dispatched alone (the engine's own
``_provisioned_row_cap`` chunks it, exactly as the collective path relies
on) unless the cap was set explicitly (``strict_admission``), in which
case it is REJECTED with :class:`AdmissionRejected` — an operator-set
bucket is a serving contract, not a hint.

Locking discipline: the queue condition is only ever held around QUEUE
STATE; the inner engine runs outside it, guarded by a dedicated device
lock that is never held while waiting on game progress.  The static rule
``BCG-LOCK-CALL`` (``bcg_tpu/analysis/rules.py``) enforces this shape for
future edits — an engine call under a scheduler/collective lock is the
deadlock class this module exists to retire.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from bcg_tpu_torch.obs import (
    alerts as obs_alerts,
    compile as obs_compile,
    counters as obs_counters,
    export as obs_export,
    fleet as obs_fleet,
    hostsync as obs_hostsync,
    ledger as obs_ledger,
    tracer as obs_tracer,
)
from bcg_tpu_torch.obs.tracer import SpanAggregator
from bcg_tpu_torch.runtime import envflags, resilience
from bcg_tpu_torch.runtime.resilience import EngineDead, EngineHung

# Serving-latency histogram bucket bounds in milliseconds (the +Inf
# overflow bucket is implicit).  These are first-class
# :class:`bcg_tpu_torch.obs.counters.Histogram`\\ s in the process-wide
# registry — Prometheus-expositable (`_bucket`/`_sum`/`_count`), with
# bucket-derived p50/p95/p99; SchedulerStats snapshots its own share
# via construction-time `Histogram.raw()` baselines.
#
# Bound rationale: queue-wait tracks the linger knob's 0-100 ms regime
# (sub-bucket resolution around the 10 ms default); e2e spans one
# device dispatch (~ms on fake engines) up to multi-second TPU decode
# windows; device-time mirrors e2e minus queueing; SLO headroom shares
# the e2e scale, with a leading 0 bound that floors every violation
# (negative headroom) into the ``le="0"`` bucket — so headroom
# quantiles clamp to 0 rather than interpolating a spurious positive
# value, and the ``le="0"`` bucket count on the exposition IS the
# violation count.
_QUEUE_WAIT_BUCKETS_MS = (1, 2, 5, 10, 20, 50, 100)
_E2E_BUCKETS_MS = (5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 15000)
_DEVICE_BUCKETS_MS = (1, 5, 10, 25, 50, 100, 250, 1000, 5000, 15000)
_SLO_HEADROOM_BUCKETS_MS = (0, 1, 5, 10, 25, 50, 100, 250, 1000, 5000)
# Recovery latency (first dispatch failure -> the batch's eventual
# completion): spans one backoff (~tens of ms) through a watchdog
# timeout + engine rebuild (seconds).
_RECOVERY_BUCKETS_MS = (5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
                        15000)
# Speculative-decoding counters the inner engine publishes
# (engine/speculative.py); snapshotted per scheduler with the same
# construction-time-baseline idiom as the linger buckets, so
# LAST_SERVE_STATS carries THIS scheduler's draft acceptance rate.
_SPEC_COUNTERS = (
    "engine.spec.drafted", "engine.spec.accepted", "engine.spec.rejected",
)


class AdmissionRejected(RuntimeError):
    """Request refused at admission: it can never fit the configured
    device bucket (strict mode) so queueing it would just stall it."""


class AdmissionDeferred(RuntimeError):
    """Request deferred at admission: its tenant's queued-row quota is
    full RIGHT NOW, but the condition is transient — retry after
    ``retry_after_s`` seconds (derived from the scheduler's live device
    latency and SLO headroom, :func:`derive_retry_after_ms`) instead of
    treating this as a hard failure.  :class:`~bcg_tpu_torch.serve.engine.
    ServingEngine` retries transparently; direct submitters decide."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


def derive_retry_after_ms(
    device_p50_ms: float,
    linger_ms: float,
    slo_ms: int = 0,
    headroom_p50_ms: Optional[float] = None,
) -> float:
    """Retry-after hint for a deferred admission, in milliseconds.

    The base is one device dispatch worth of time (the median device
    latency, floored by the linger window and 1 ms): a deferred tenant's
    quota frees exactly when one of its queued batches dispatches, so
    retrying sooner than a dispatch takes is pure spin.  Under a
    configured SLO the base is scaled by admission PRESSURE read off the
    ``serve.slo.headroom_ms`` histogram's median: full headroom
    (p50 == objective) leaves the base untouched, exhausted headroom
    (p50 at/under 0 — the le=0 violation bucket) quadruples it.  The
    scale is monotone non-increasing in headroom by construction —
    perf_gate's ``sweep.retry_after_monotonicity`` metric pins that
    shape, so the backoff can never invert under load."""
    base = max(float(linger_ms), float(device_p50_ms), 1.0)
    if not slo_ms or headroom_p50_ms is None:
        return base
    frac = min(1.0, max(0.0, float(headroom_p50_ms) / float(slo_ms)))
    return base * (4.0 - 3.0 * frac)


class TenantState:
    """Per-tenant accounting for multi-tenant scheduling (the sweep
    tier's games-as-tenants model, :mod:`bcg_tpu_torch.sweep`).

    ``weight`` sets the tenant's fair share of dispatched rows
    (weighted-fair ordering keys on ``served_rows / weight``);
    ``priority`` orders strictly above fairness (higher first);
    ``quota_rows`` bounds the tenant's QUEUED rows — a submit past it
    is deferred with a retry-after, never hard-rejected.  A lone
    request larger than the quota still admits once the tenant's queue
    is empty (the admission watermark's oversize carve-out), so
    ``max_queued_rows`` can exceed the quota only by way of such a
    request's own rows."""

    __slots__ = ("name", "weight", "priority", "quota_rows", "queued_rows",
                 "served_rows", "deferrals", "max_queued_rows")

    def __init__(self, name: str, weight: float = 1.0, priority: int = 0,
                 quota_rows: Optional[int] = None):
        if weight <= 0:
            raise ValueError(f"tenant {name!r}: weight must be > 0")
        self.name = name
        self.weight = float(weight)
        self.priority = int(priority)
        self.quota_rows = quota_rows
        self.queued_rows = 0
        self.served_rows = 0
        self.deferrals = 0
        self.max_queued_rows = 0  # high-water: quota-exactness evidence

    @property
    def vtime(self) -> float:
        """Weighted virtual time: the tenant with the SMALLEST vtime is
        the most underserved and dispatches next (start-time fair
        queueing over rows)."""
        return self.served_rows / self.weight

    def snapshot(self) -> Dict[str, Any]:
        return {
            "weight": self.weight,
            "priority": self.priority,
            "quota_rows": self.quota_rows,
            "queued_rows": self.queued_rows,
            "served_rows": self.served_rows,
            "deferrals": self.deferrals,
            "max_queued_rows": self.max_queued_rows,
        }


class RequestCancelled(TimeoutError):
    """Request missed its deadline before dispatch (or the scheduler
    went away while it was queued)."""


class SchedulerClosed(RuntimeError):
    """Submitted to (or queued on) a scheduler that has shut down."""


class Request:
    """One engine call from one participant, completed independently."""

    __slots__ = ("sig", "payload", "n_rows", "temps", "budgets", "deadline",
                 "submitted_at", "enqueued_at", "done", "results", "error",
                 "span", "req_id", "tenant")

    _ids = itertools.count(1)  # process-wide: ids stay unique across schedulers

    def __init__(self, sig: Tuple, payload: List, temps: List[float],
                 budgets: List[int], deadline: Optional[float],
                 tenant: Optional[str] = None):
        self.req_id = next(Request._ids)
        self.tenant = tenant
        self.sig = sig
        self.payload = payload
        self.n_rows = len(payload)
        self.temps = temps
        self.budgets = budgets
        self.deadline = deadline      # absolute time.monotonic(), or None
        self.submitted_at = 0.0       # submit() entry — the e2e/SLO anchor
        self.enqueued_at = 0.0
        self.done = threading.Event()
        self.results: Optional[List] = None
        self.error: Optional[BaseException] = None
        # Submitter-side span handle (the explicit cross-thread parent
        # for the dispatch thread's queue_wait/batch_form/device spans);
        # None when tracing is off or the submitter ran unspanned.
        self.span = None

    def fail(self, error: BaseException) -> None:
        self.error = error
        self.done.set()

    def complete(self, results: List) -> None:
        self.results = results
        self.done.set()


class SchedulerStats:
    """Counters + per-stage latency; mutated only under the scheduler
    condition, snapshotted for :mod:`bcg_tpu_torch.runtime.metrics`.

    The latency histograms (``serve.queue_wait_ms`` / ``serve.e2e_ms``
    / ``serve.device_ms`` and, under an SLO, ``serve.slo.headroom_ms``)
    live in the PROCESS-WIDE counter registry as first-class
    :class:`~bcg_tpu_torch.obs.counters.Histogram`\\ s — this instance records
    construction-time ``raw()`` baselines and snapshots its own share
    as deltas, so per-scheduler numbers stay correct when several
    schedulers run in one process (sequentially; concurrent schedulers
    share the registry totals).  Stage latency
    (queue_wait/admission/batch_form/device/scatter) accumulates in a
    :class:`~bcg_tpu_torch.obs.tracer.SpanAggregator` that the tracer spans
    feed — one timing implementation for the trace and the snapshot.
    """

    def __init__(self, slo_ms: int = 0):
        self.submitted = 0
        self.completed = 0
        self.failed = 0            # engine raised for the request's batch
        self.cancelled = 0         # deadline expiry / close while queued
        self.rejected = 0          # strict admission refusals
        self.deferred = 0          # tenant-quota deferrals (retry-after)
        self.dispatches = 0
        self.dispatched_rows = 0
        self.merged_dispatches = 0  # dispatches that merged >1 request
        self.oversize_dispatches = 0
        self.engine_errors = 0
        # Recovery tier (BCG_TPU_SERVE_MAX_DISPATCH_RETRIES /
        # BCG_TPU_SERVE_WATCHDOG_S): retried attempts, bisecting batch
        # splits, dispatches that completed after >=1 failure, and
        # supervisor engine rebuilds.
        self.dispatch_retries = 0
        self.batch_splits = 0
        self.recoveries = 0
        self.engine_rebuilds = 0
        self.backpressure_blocks = 0
        self.max_queue_rows = 0
        self.slo_ms = max(0, slo_ms)
        self.slo_violations = 0
        # Host-sync accounting (BCG_TPU_HOSTSYNC): device->host
        # transfers observed across THIS scheduler's engine dispatches
        # (auditor-total deltas read INSIDE the device lock, bracketing
        # only the engine call; see _dispatch for the shared-total
        # caveat under concurrent non-serve auditing).
        self.dispatch_syncs = 0
        self.lat = SpanAggregator()
        self._hists = {
            "queue_wait": obs_counters.histogram(
                "serve.queue_wait_ms", _QUEUE_WAIT_BUCKETS_MS),
            "e2e": obs_counters.histogram("serve.e2e_ms", _E2E_BUCKETS_MS),
            "device": obs_counters.histogram(
                "serve.device_ms", _DEVICE_BUCKETS_MS),
            "recovery": obs_counters.histogram(
                "serve.recovery_ms", _RECOVERY_BUCKETS_MS),
        }
        if self.slo_ms:
            # Headroom = slo - e2e per completed request; negative
            # observations (violations) floor into the le=0 bucket, so
            # derived quantiles read 0 at/past the objective (the true
            # signed magnitude is in .sum and the violations counter).
            # The histogram only exists once an SLO is configured — the
            # default path registers nothing.
            self._hists["slo_headroom"] = obs_counters.histogram(
                "serve.slo.headroom_ms", _SLO_HEADROOM_BUCKETS_MS)
        self._hist_base = {k: h.raw() for k, h in self._hists.items()}
        self._spec_base = [obs_counters.value(name) for name in _SPEC_COUNTERS]

    def record_linger(self, seconds: float) -> None:
        self.lat.add("queue_wait", seconds)
        self._hists["queue_wait"].observe(seconds * 1e3)

    def record_completion(self, e2e_seconds: float) -> int:
        """Observe one completed request's submit->complete latency;
        returns 1 when it violated the configured SLO (0 otherwise —
        incl. when no SLO is set)."""
        e2e_ms = e2e_seconds * 1e3
        self._hists["e2e"].observe(e2e_ms)
        if not self.slo_ms:
            return 0
        headroom = self.slo_ms - e2e_ms
        self._hists["slo_headroom"].observe(headroom)
        return 1 if headroom < 0 else 0

    def record_device_time(self, seconds: float) -> None:
        self._hists["device"].observe(seconds * 1e3)

    def record_recovery(self, seconds: float) -> None:
        """Observe one recovered dispatch's first-failure -> completion
        latency (retries, backoff, splits, and any engine rebuild all
        inside the window)."""
        self._hists["recovery"].observe(seconds * 1e3)

    def _hist_delta(self, key: str):
        """(per-bucket counts incl. overflow, sum, count) movement since
        construction — THIS scheduler's share of the process total."""
        counts, total, n = self._hists[key].raw()
        base_counts, base_total, base_n = self._hist_base[key]
        return (
            [c - b for c, b in zip(counts, base_counts)],
            total - base_total, n - base_n,
        )

    def _hist_snapshot(self, key: str) -> Dict[str, Any]:
        from bcg_tpu_torch.obs.counters import quantile_from_counts

        counts, total, n = self._hist_delta(key)
        bounds = self._hists[key].bounds
        return {
            "count": n,
            "sum_ms": round(total, 3),
            "p50_ms": round(quantile_from_counts(bounds, counts, 0.50), 3),
            "p95_ms": round(quantile_from_counts(bounds, counts, 0.95), 3),
            "p99_ms": round(quantile_from_counts(bounds, counts, 0.99), 3),
        }

    def snapshot(self, row_cap: Optional[int] = None,
                 queue_rows: int = 0,
                 kv_pool: Optional[Dict[str, Any]] = None,
                 tenants: Optional[Dict[str, "TenantState"]] = None,
                 ) -> Dict[str, Any]:
        done = (self.completed + self.failed + self.cancelled
                + self.rejected + self.deferred)
        hist_keys = [f"<={b}ms" for b in _QUEUE_WAIT_BUCKETS_MS] + [
            f">{_QUEUE_WAIT_BUCKETS_MS[-1]}ms"
        ]
        hist, _, _ = self._hist_delta("queue_wait")
        lat_table = self.lat.table()
        queue_wait = lat_table.get("queue_wait")
        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "cancelled": self.cancelled,
            "rejected": self.rejected,
            "deferred": self.deferred,
            "pending": self.submitted - done,  # queued or mid-dispatch
            "queue_rows": queue_rows,
            "max_queue_rows": self.max_queue_rows,
            "dispatches": self.dispatches,
            "dispatched_rows": self.dispatched_rows,
            "merged_dispatches": self.merged_dispatches,
            "oversize_dispatches": self.oversize_dispatches,
            "engine_errors": self.engine_errors,
            "backpressure_blocks": self.backpressure_blocks,
            "row_cap": row_cap,
            "batch_occupancy": (
                round(self.dispatched_rows / (self.dispatches * row_cap), 4)
                if row_cap and self.dispatches else None
            ),
            # Mean over DISPATCHED requests only: rejected/cancelled
            # requests never lingered to dispatch, so counting them
            # would understate latency exactly under overload.
            "mean_linger_ms": (
                queue_wait["mean_ms"] if queue_wait else None
            ),
            "linger_hist_ms": dict(zip(hist_keys, hist)),
            # Registry-histogram views (THIS scheduler's share):
            # bucket-derived p50/p95/p99 per serve.queue_wait_ms /
            # serve.e2e_ms / serve.device_ms.
            "hist_ms": {
                key: self._hist_snapshot(key)
                for key in ("queue_wait", "e2e", "device")
            },
            # SLO view (BCG_TPU_SERVE_SLO_MS): violations = completed
            # requests whose submit->complete latency exceeded the
            # objective; headroom_ms quantiles come from the
            # serve.slo.headroom_ms histogram (violations floor to 0 —
            # a p95 of 0 reads "at or past the objective").  None when
            # no SLO is set.
            "slo": (
                {
                    "slo_ms": self.slo_ms,
                    "violations": self.slo_violations,
                    "headroom_ms": self._hist_snapshot("slo_headroom"),
                }
                if self.slo_ms else None
            ),
            # Per-stage latency breakdown (count/total/mean/p50/p95 ms):
            # queue_wait = enqueue->dispatch, admission = backpressure
            # wait in submit, batch_form = merge assembly, device = the
            # inner engine call (incl. device-lock wait), scatter =
            # result distribution.
            "latency_ms": {
                name.split(".", 1)[-1]: row
                for name, row in lat_table.items()
            },
            # Recovery view (BCG_TPU_SERVE_MAX_DISPATCH_RETRIES /
            # BCG_TPU_SERVE_WATCHDOG_S): retried attempts, bisecting
            # batch splits, dispatches completed after >=1 failure with
            # their failure->completion latency, and supervisor engine
            # rebuilds.  None while nothing ever failed (the kv_pool
            # idiom — a clean run carries no extra surface).
            "recovery": (
                {
                    "dispatch_retries": self.dispatch_retries,
                    "batch_splits": self.batch_splits,
                    "recoveries": self.recoveries,
                    "engine_rebuilds": self.engine_rebuilds,
                    "recovery_ms": self._hist_snapshot("recovery"),
                }
                if (self.dispatch_retries or self.batch_splits
                    or self.recoveries or self.engine_rebuilds) else None
            ),
            # Speculative-decoding acceptance under THIS scheduler
            # (None when the inner engine drafted nothing — spec off or
            # fake backend without the mirror).
            "spec": self._spec_snapshot(),
            # HBM ledger view (bcg_tpu/obs/ledger.py): what the device
            # currently holds (params / KV slab / prefix entries / spec
            # slots) and the admission headroom left under the declared
            # limit — the byte-level counterpart of row_cap (None
            # throughout on CPU where no limit is known).
            "hbm": obs_ledger.snapshot(),
            # Block-paged pool view (engine.kv_pool_stats): free-block
            # headroom + radix prefix hit rate — the block-level
            # counterpart of row_cap on paged engines (None on dense).
            "kv_pool": kv_pool,
            # Host-sync view (BCG_TPU_HOSTSYNC): device->host transfers
            # this scheduler's dispatches performed, normalized per
            # dispatch and per completed request — the serve-side form
            # of ROADMAP item 1's syncs-per-round metric.  None when
            # the auditor is off (kv_pool idiom).
            "hostsync": (
                {
                    "syncs": self.dispatch_syncs,
                    "syncs_per_dispatch": (
                        round(self.dispatch_syncs / self.dispatches, 4)
                        if self.dispatches else None
                    ),
                    "syncs_per_request": (
                        round(self.dispatch_syncs / self.completed, 4)
                        if self.completed else None
                    ),
                }
                if obs_hostsync.enabled() else None
            ),
            # Multi-tenant view (the sweep tier's games-as-tenants
            # model): per-tenant fair-share accounting — served rows,
            # queued rows vs quota (max_queued_rows is the quota-
            # exactness evidence: it can never exceed quota_rows), and
            # retry-after deferrals.  None when no tenant ever
            # registered (single-tenant schedulers carry no extra
            # surface).
            "tenants": (
                {name: t.snapshot() for name, t in sorted(tenants.items())}
                if tenants else None
            ),
            # Compile-cost view (BCG_TPU_COMPILE_OBS, obs/compile.py):
            # trace-cache population, retrace/cause totals, and the
            # cumulative compile milliseconds this process has paid —
            # the admission-side early warning that a sweep's per-tenant
            # signatures are multiplying jit entries.  None when the
            # observer is off (kv_pool idiom).
            "compile": obs_compile.brief(),
        }

    def _spec_snapshot(self) -> Optional[Dict[str, Any]]:
        drafted, accepted, rejected = (
            obs_counters.value(name) - base
            for name, base in zip(_SPEC_COUNTERS, self._spec_base)
        )
        if not drafted:
            return None
        return {
            "drafted": drafted,
            "accepted": accepted,
            "rejected": rejected,
            "acceptance_rate": round(accepted / drafted, 4),
        }


def derive_row_cap(engine) -> Optional[int]:
    """KV-budget row cap from the inner engine, or None when the engine
    exposes no budget (fake/stub engines, CPU).  Uses the engine's own
    ``cap_for`` at the worst-case decode window so the scheduler's merge
    accounting agrees byte-for-byte with ``_check_kv_budget``."""
    cap_for = getattr(engine, "cap_for", None)
    max_len = getattr(engine, "max_model_len", None)
    if cap_for is None or not max_len:
        return None
    # Engines whose decode loops over-allocate cache past the token
    # budget (fast-forward's compacted tail, speculation's K+1 verify
    # window) expose the true worst-case window — as a method OR a plain
    # int attribute (a non-callable int was once silently ignored in
    # favor of max_model_len, under-sizing the window exactly for the
    # engines that declared one); max_model_len only covers engines
    # declaring nothing.
    window = getattr(engine, "worst_case_decode_window", None)
    if callable(window):
        window = window()
    return cap_for(int(window) if window else int(max_len))


class Scheduler:
    """Request queue + dispatch thread over one inner engine.

    Parameters default from the ``BCG_TPU_SERVE_*`` env flags
    (:mod:`bcg_tpu_torch.runtime.envflags`); pass explicit values to override.

    ``bucket_rows``: target device-batch rows.  0 (default) derives the
    cap from the engine's KV budget (:func:`derive_row_cap`); an explicit
    value also enables ``strict_admission`` unless overridden.

    Recovery tier (DESIGN.md "Failure model & recovery"):
    ``max_dispatch_retries`` (``BCG_TPU_SERVE_MAX_DISPATCH_RETRIES``)
    retries a failed device batch with capped exponential backoff +
    jitter, then bisects it to isolate poison requests;
    ``watchdog_s`` (``BCG_TPU_SERVE_WATCHDOG_S``) bounds each device
    call — a hung call triggers the engine supervisor, which rebuilds
    the engine ONCE via ``engine_factory`` (abandoning the hung call's
    thread and device lock) before declaring the scheduler dead.  All
    three default to off, preserving fail-on-first-error semantics.
    """

    def __init__(
        self,
        engine,
        *,
        linger_ms: Optional[int] = None,
        bucket_rows: Optional[int] = None,
        max_queue_rows: Optional[int] = None,
        deadline_ms: Optional[int] = None,
        strict_admission: Optional[bool] = None,
        slo_ms: Optional[int] = None,
        fair: bool = True,
        max_dispatch_retries: Optional[int] = None,
        watchdog_s: Optional[float] = None,
        engine_factory=None,
    ):
        self._engine = engine
        if linger_ms is None:
            linger_ms = envflags.get_int("BCG_TPU_SERVE_LINGER_MS")
        if bucket_rows is None:
            bucket_rows = envflags.get_int("BCG_TPU_SERVE_BUCKET_ROWS")
        if max_queue_rows is None:
            max_queue_rows = envflags.get_int("BCG_TPU_SERVE_MAX_QUEUE_ROWS")
        if deadline_ms is None:
            deadline_ms = envflags.get_int("BCG_TPU_SERVE_DEADLINE_MS")
        if slo_ms is None:
            slo_ms = envflags.get_int("BCG_TPU_SERVE_SLO_MS")
        self._linger_s = max(0, linger_ms) / 1e3
        if bucket_rows and bucket_rows > 0:
            self._row_cap: Optional[int] = int(bucket_rows)
            explicit_cap = True
        else:
            self._row_cap = derive_row_cap(engine)
            explicit_cap = False
        self._strict = explicit_cap if strict_admission is None else strict_admission
        self._max_queue_rows = max(1, max_queue_rows)
        self._deadline_s = max(0, deadline_ms) / 1e3
        if max_dispatch_retries is None:
            max_dispatch_retries = envflags.get_int(
                "BCG_TPU_SERVE_MAX_DISPATCH_RETRIES"
            )
        if watchdog_s is None:
            watchdog_s = envflags.get_int("BCG_TPU_SERVE_WATCHDOG_S")
        self._max_retries = max(0, int(max_dispatch_retries))
        self._watchdog_s = max(0.0, float(watchdog_s))
        self._engine_factory = engine_factory
        # Supervisor budget: ONE rebuild per scheduler lifetime — a
        # second hang means the fault is not transient and the
        # scheduler declares itself dead instead of cycling engines.
        self._rebuilds_left = 1 if engine_factory is not None else 0
        # Seeded: backoff jitter must not depend on global RNG state
        # (hermetic chaos tests assert recovery counters exactly).
        self._retry_rng = random.Random(0x5EED)
        self.stats = SchedulerStats(slo_ms=slo_ms)

        self._cond = threading.Condition()
        self._queue: List[Request] = []
        self._queue_rows = 0
        self._closed = False
        # True between a hang-watchdog engine rebuild and the first
        # dispatch the fresh engine completes — the /readyz "hang
        # window".  Only the dispatch thread writes it.
        self._engine_unready = False
        # Multi-tenant scheduling (games-as-tenants, bcg_tpu/sweep):
        # empty = every request rides the anonymous default tenant and
        # dispatch order is byte-identical to the single-tenant
        # scheduler (FIFO within signature groups).  ``fair=False`` is
        # the perf_gate fairness-off injection arm — tenants register
        # and quotas enforce, but batch selection degrades to FIFO.
        self._tenants: Dict[str, TenantState] = {}
        self._fair = fair
        # Shared fair-share account for UNTENANTED requests on a
        # tenanted scheduler: without it they would carry a permanent
        # virtual time of 0 and outrank every tenant with history —
        # exactly the starvation fairness exists to prevent.  No quota,
        # excluded from the snapshot's tenants block.
        self._anon_tenant = TenantState("(untenanted)")
        # Serializes device access: held ONLY around the inner engine
        # call itself, never while holding self._cond and never while a
        # request waits for queue admission — so it cannot participate in
        # a lock-ordering cycle with game progress.
        self._device_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="bcg-serve-scheduler", daemon=True
        )
        self._thread.start()
        # Telemetry endpoint (BCG_TPU_METRICS_PORT) + fleet metric-shard
        # flusher (BCG_TPU_METRICS_SHARD_DIR): idempotent no-ops when
        # disabled; a FakeEngine serving run is scrapeable/shardable too.
        obs_export.maybe_start_http_server()
        obs_fleet.maybe_start_shard_writer()
        # Health & alerting plane (BCG_TPU_ALERTS, bcg_tpu/obs/alerts.py):
        # start the rule evaluator (no-op when off) and hook this
        # scheduler's lifecycle into the readiness state behind /readyz —
        # booted+accepting now, unready across the hang window /
        # EngineDead, shed-worthy at the backpressure watermark (pull
        # probe: sampled at request time, not evented).
        obs_alerts.maybe_start()
        obs_alerts.mark_ready("scheduler")
        obs_alerts.mark_ready("engine")
        obs_alerts.register_readiness_probe(
            "backpressure", self._backpressure_probe
        )

    # -------------------------------------------------------------- tenancy

    def register_tenant(self, name: str, *, weight: float = 1.0,
                        priority: int = 0,
                        quota_rows: Optional[int] = None) -> TenantState:
        """Declare (or re-fetch) a tenant.  Idempotent per name — a
        re-registration updates weight/priority/quota but keeps the
        served-rows history, so a resumed sweep job re-registering its
        tenant does not reset its fair-share position."""
        with self._cond:
            t = self._tenants.get(name)
            if t is None:
                t = self._tenants[name] = TenantState(
                    name, weight=weight, priority=priority,
                    quota_rows=quota_rows,
                )
            else:
                if weight <= 0:
                    raise ValueError(f"tenant {name!r}: weight must be > 0")
                t.weight = float(weight)
                t.priority = int(priority)
                t.quota_rows = quota_rows
            return t

    def tenant_stats(self) -> Optional[Dict[str, Dict[str, Any]]]:
        with self._cond:
            if not self._tenants:
                return None
            return {n: t.snapshot() for n, t in sorted(self._tenants.items())}

    def retry_after_ms(self) -> float:
        """Live retry-after hint (see :func:`derive_retry_after_ms`):
        median device latency scaled by SLO-headroom pressure."""
        device_p50 = self.stats._hist_snapshot("device")["p50_ms"]
        headroom = None
        if self.stats.slo_ms:
            h = self.stats._hist_snapshot("slo_headroom")
            headroom = h["p50_ms"] if h["count"] else None
        return derive_retry_after_ms(
            device_p50, self._linger_s * 1e3, self.stats.slo_ms, headroom
        )

    def _fair_tenant(self, req: Request) -> TenantState:
        """The fair-share account a request charges: its registered
        tenant, or the shared untenanted account (unregistered tenant
        names included — an unknown name must not mint a zero-history
        queue-jumper)."""
        t = self._tenants.get(req.tenant) if req.tenant else None
        return t if t is not None else self._anon_tenant

    def _fair_key(self, req: Request):
        """Batch-selection order under tenancy: priority class strictly
        first (higher dispatches sooner), then weighted virtual time
        (most underserved tenant first), then arrival — which is the
        whole ordering (pure FIFO) when no tenants exist or fairness is
        disabled."""
        t = self._fair_tenant(req)
        return (-t.priority, t.vtime, req.enqueued_at, req.req_id)

    # ------------------------------------------------------------ submission

    def submit(self, sig: Tuple, payload: List, temps: List[float],
               budgets: List[int], tenant: Optional[str] = None) -> Request:
        """Enqueue one call; returns its :class:`Request` future.

        Blocks for queue admission (backpressure) when the queued row
        count would exceed ``max_queue_rows``; rejects oversize requests
        under strict admission.  ``tenant`` attributes the request to a
        registered tenant: its queued-row quota is enforced here (a
        full quota fails the request with :class:`AdmissionDeferred`
        carrying a retry-after — transient, unlike the strict-admission
        reject) and its weight/priority order batch selection."""
        now = time.monotonic()
        deadline = now + self._deadline_s if self._deadline_s > 0 else None
        req = Request(sig, payload, temps, budgets, deadline, tenant=tenant)
        req.submitted_at = now
        # Cross-thread parent handoff: the dispatch thread parents its
        # queue_wait/batch_form/device spans to the submitter's
        # innermost open span (the serve.request span when called via
        # submit_and_wait, or whatever phase span the game thread holds).
        req.span = obs_tracer.current()
        obs_counters.inc("serve.requests")
        with self._cond:
            self.stats.submitted += 1
            if self._closed:
                self.stats.cancelled += 1
                req.fail(SchedulerClosed("scheduler is shut down"))
                self._emit(req, "cancelled", reason="scheduler_closed")
                return req
            if (self._row_cap is not None and self._strict
                    and req.n_rows > self._row_cap):
                self.stats.rejected += 1
                req.fail(AdmissionRejected(
                    f"request of {req.n_rows} rows exceeds the device "
                    f"bucket of {self._row_cap} rows"
                ))
                self._emit(req, "rejected", row_cap=self._row_cap)
                return req
            blocked = False
            # A lone request larger than the watermark must still admit
            # once the queue drains (compare against max(watermark, n):
            # blocking it unconditionally would hang the submitter
            # forever on an empty queue).
            watermark = max(self._max_queue_rows, req.n_rows)
            with obs_tracer.span("serve.admission", parent=req.span,
                                 aggregate=self.stats.lat,
                                 args={"rows": req.n_rows}):
                while (self._queue_rows + req.n_rows > watermark
                       and not self._closed):
                    if not blocked:
                        blocked = True
                        self.stats.backpressure_blocks += 1
                    timeout = None
                    if req.deadline is not None:
                        timeout = req.deadline - time.monotonic()
                        if timeout <= 0:
                            self.stats.cancelled += 1
                            req.fail(RequestCancelled(
                                "deadline expired waiting for queue admission"
                            ))
                            self._emit(req, "cancelled",
                                       reason="admission_deadline")
                            return req
                    self._cond.wait(timeout if timeout is not None else 1.0)
                    if not self._thread.is_alive() and not self._closed:
                        # Dead-scheduler detection for admission waiters
                        # (the submit_and_wait counterpart): a queue that
                        # can never drain must not block a submitter
                        # forever.
                        self.stats.cancelled += 1
                        req.fail(SchedulerClosed(
                            "scheduler thread died while this request "
                            "waited for queue admission"
                        ))
                        self._emit(req, "cancelled", reason="scheduler_died")
                        return req
            if self._closed:
                self.stats.cancelled += 1
                req.fail(SchedulerClosed("scheduler shut down during admission"))
                self._emit(req, "cancelled", reason="closed_during_admission")
                return req
            # Tenant quota, checked AND charged under this same lock
            # hold (checking before the backpressure wait would let a
            # second same-tenant submit slip in while this one slept,
            # overshooting the quota).  Quota full is TRANSIENT — it
            # frees when one of the tenant's queued batches dispatches —
            # so defer with a retry-after instead of hard-rejecting: a
            # sweep tenant under pressure backs off instead of dying.
            t = self._tenants.get(tenant) if tenant else None
            # A lone request LARGER than the quota must still admit once
            # the tenant's queue drains (compare against max(quota, n):
            # deferring it unconditionally would livelock the
            # ServingEngine retry loop forever — the admission
            # watermark's oversize carve-out, applied to quotas).
            quota = (
                max(t.quota_rows, req.n_rows)
                if t is not None and t.quota_rows is not None else None
            )
            if quota is not None and t.queued_rows + req.n_rows > quota:
                self.stats.deferred += 1
                t.deferrals += 1
                retry_s = self.retry_after_ms() / 1e3
                req.fail(AdmissionDeferred(
                    f"tenant {tenant!r} quota of {t.quota_rows} rows is "
                    f"full ({t.queued_rows} queued); retry after "
                    f"{retry_s * 1e3:.1f} ms",
                    retry_after_s=retry_s,
                ))
                obs_counters.inc("serve.deferrals")
                self._emit(req, "deferred", tenant=tenant,
                           quota_rows=t.quota_rows,
                           retry_after_ms=round(retry_s * 1e3, 3))
                return req
            req.enqueued_at = time.monotonic()
            self._queue.append(req)
            self._queue_rows += req.n_rows
            if t is not None:
                t.queued_rows += req.n_rows
                t.max_queued_rows = max(t.max_queued_rows, t.queued_rows)
            self.stats.max_queue_rows = max(
                self.stats.max_queue_rows, self._queue_rows
            )
            self._cond.notify_all()
        self._emit(req, "admitted", queue_rows=self._queue_rows)
        return req

    @staticmethod
    def _emit(req: Request, event: str, **fields: Any) -> None:
        """One request-lifecycle line to the JSONL sink
        (BCG_TPU_SERVE_EVENTS; no-op when unset)."""
        obs_export.emit_event(
            event, req_id=req.req_id, rows=req.n_rows, sig=str(req.sig),
            **fields,
        )

    def submit_and_wait(self, sig: Tuple, payload: List, temps: List[float],
                        budgets: List[int],
                        tenant: Optional[str] = None) -> List:
        """Enqueue and block until completion; raises the request's error.

        The whole submit→complete lifetime is one ``serve.request`` span
        on the CALLING thread (balanced there); the dispatch-side spans
        reference it across the thread boundary via ``Request.span``.
        """
        with obs_tracer.span("serve.request",
                             args={"rows": len(payload), "sig": str(sig)}):
            req = self.submit(sig, payload, temps, budgets, tenant=tenant)
            while not req.done.wait(timeout=5.0):
                # Lost-wakeup / dead-scheduler safety net, not a timer: a
                # request can wait arbitrarily long behind real traffic,
                # but must not wait forever on a scheduler that died.
                if not self._thread.is_alive() and not req.done.is_set():
                    raise SchedulerClosed(
                        "scheduler thread died with this request pending"
                    )
        if req.error is not None:
            raise req.error
        return req.results  # type: ignore[return-value]

    # ---------------------------------------------------------- dispatch loop

    def _loop(self) -> None:
        while True:
            with self._cond:
                batch: Optional[List[Request]] = None
                while batch is None:
                    if self._closed:
                        return
                    now = time.monotonic()
                    self._cancel_expired_locked(now)
                    batch = self._form_batch_locked(now)
                    if batch is None:
                        self._cond.wait(self._wakeup_timeout_locked(now))
                if len(batch) > 1:
                    self.stats.merged_dispatches += 1
                if (self._row_cap is not None
                        and sum(r.n_rows for r in batch) > self._row_cap):
                    self.stats.oversize_dispatches += 1
                dispatch_t = time.monotonic()
                for r in batch:
                    wait_s = dispatch_t - r.enqueued_at
                    self.stats.record_linger(wait_s)
                    # The wait's endpoints live on two threads (enqueue
                    # on the submitter, dispatch here), so it exports as
                    # one complete (X) event parented to the request's
                    # submitter-side span.
                    obs_tracer.complete(
                        "serve.queue_wait", wait_s, parent=r.span,
                        args={"rows": r.n_rows},
                    )
                    self._emit(
                        r, "dispatched",
                        queue_wait_ms=round(wait_s * 1e3, 3),
                        batch_requests=len(batch),
                    )
            # Profiler capture window (BCG_TPU_PROFILE, obs/compile.py):
            # dispatches are the serve tier's "rounds" — the configured
            # a-b window wraps them in one bounded jax.profiler trace.
            # Shared no-op when capture is off.
            with obs_compile.profile_dispatch():
                self._dispatch(batch)
            # Fleet liveness: every dispatch advances this rank's
            # progress watermark (no-op when fleet stamping is off).
            # Peer ranks' lagging dispatch watermarks surface as the
            # fleet.stragglers gauge via the shard flusher thread's
            # periodic check_stragglers pass — detection only has
            # inputs when shards are on, and running the peer-shard
            # scan there keeps its I/O off this dispatch thread.
            obs_fleet.note_dispatch()
            self._publish_stats()

    def _cancel_expired_locked(self, now: float) -> None:
        expired = [r for r in self._queue
                   if r.deadline is not None and now >= r.deadline]
        if not expired:
            return
        for r in expired:
            self.stats.cancelled += 1
            self._uncharge_tenant_locked(r)
            r.fail(RequestCancelled(
                f"deadline expired after {now - r.enqueued_at:.3f}s in queue"
            ))
            self._emit(r, "cancelled", reason="queue_deadline",
                       queued_ms=round((now - r.enqueued_at) * 1e3, 3))
        self._queue = [r for r in self._queue if not r.done.is_set()]
        self._queue_rows = sum(r.n_rows for r in self._queue)
        self._cond.notify_all()

    def _uncharge_tenant_locked(self, req: Request) -> None:
        """Release one request's queued-row quota charge (called under
        the condition for every path that removes it from the queue)."""
        t = self._tenants.get(req.tenant) if req.tenant else None
        if t is not None:
            t.queued_rows = max(0, t.queued_rows - req.n_rows)

    def _form_batch_locked(self, now: float) -> Optional[List[Request]]:
        """Oldest-first over signature groups: dispatch a group when its
        bucket is full (>= row cap) or its oldest member has lingered past
        the linger deadline.  Returns the chosen requests, removed from
        the queue, or None when nothing is ripe yet.

        Under tenancy (any registered tenant, ``fair=True``), both the
        group-scan order and the within-group fill order follow
        :meth:`_fair_key` — priority class, then weighted virtual time,
        then arrival — so a tenant flooding the queue with rows cannot
        push another tenant's requests behind its whole backlog
        (weighted-fair queueing over dispatched rows).  Ripeness itself
        stays arrival-based (a group's OLDEST member starts the linger
        clock), so fairness reorders who rides a capped batch, never
        when a batch becomes due."""
        if not self._queue:
            return None
        fair = bool(self._tenants) and self._fair
        heads = (
            sorted(self._queue, key=self._fair_key) if fair else self._queue
        )
        seen: List[Tuple] = []
        for head in heads:
            if head.sig in seen:
                continue
            seen.append(head.sig)
            group = [r for r in self._queue if r.sig == head.sig]
            rows = sum(r.n_rows for r in group)
            full = self._row_cap is not None and rows >= self._row_cap
            lingered = now - group[0].enqueued_at >= self._linger_s
            if not (full or lingered):
                continue
            order = sorted(group, key=self._fair_key) if fair else group
            batch: List[Request] = []
            taken = 0
            for r in order:
                if (batch and self._row_cap is not None
                        and taken + r.n_rows > self._row_cap):
                    break
                batch.append(r)
                taken += r.n_rows
            chosen = set(map(id, batch))
            self._queue = [r for r in self._queue if id(r) not in chosen]
            self._queue_rows -= taken
            for r in batch:
                self._uncharge_tenant_locked(r)
                # Fair-share charge lands at SELECTION (start-time
                # fairness): the next batch formation already sees this
                # account's advanced virtual time (untenanted requests
                # charge the shared anonymous account).
                self._fair_tenant(r).served_rows += r.n_rows
            self._cond.notify_all()  # backpressure waiters may now fit
            return batch
        return None

    def _wakeup_timeout_locked(self, now: float) -> Optional[float]:
        """Sleep until the earliest linger expiry or request deadline."""
        if not self._queue:
            return None
        wake = min(r.enqueued_at + self._linger_s for r in self._queue)
        deadlines = [r.deadline for r in self._queue if r.deadline is not None]
        if deadlines:
            wake = min(wake, min(deadlines))
        return max(0.001, wake - now)

    def _dispatch(self, batch: List[Request],
                  _fail_t0: Optional[float] = None,
                  _retries_left: Optional[int] = None) -> None:
        """Run one merged inner-engine call and scatter results.

        Runs on the scheduler thread with NO scheduler lock held; an
        engine failure reaches only this batch's futures — the loop and
        every other queued request keep going (crash-isolated completion).

        Recovery ladder (``max_dispatch_retries`` > 0): a failed engine
        call is retried with capped exponential backoff + jitter; when
        the budget is exhausted and the batch merged more than one
        request, it is BISECTED and each half re-dispatched (recursing
        down to per-request granularity — the split isolates poison
        requests so one bad row cannot take a whole merged batch's
        futures down).  A hang past the watchdog raises
        :class:`EngineHung` after the supervisor rebuilds the engine
        (retried without consuming the retry budget — the one-rebuild
        budget already bounds it) or :class:`EngineDead` when the
        rebuild budget is gone, which fails the batch AND declares the
        scheduler dead.  ``_fail_t0`` threads the FIRST failure time
        through split recursion so ``serve.recovery_ms`` measures
        failure -> eventual completion, not per-leaf retry time.

        Bounds: the retry budget is spent ONCE, at the top level —
        split children run with ``_retries_left=0`` (one attempt each,
        splitting further on failure), so a deterministic failure on an
        N-request batch costs at most ``retries + 2N-1`` engine calls,
        not a fresh ladder per tree node.  A failure classified
        PERMANENT (:func:`resilience.classify_failure` — value/config
        errors that deterministically recur) skips the remaining
        retries and their backoff sleeps entirely and goes straight to
        isolation: retrying it would stall the single dispatch thread
        re-running the same crash.
        """
        sig = batch[0].sig
        # Dispatch-side spans parent to the OLDEST request in the batch
        # (batch[0] — _form_batch_locked picks oldest-first): one
        # lineage anchor per merged batch; per-request attribution rides
        # the queue_wait events above.
        anchor = batch[0].span
        with obs_tracer.span("serve.batch_form", parent=anchor,
                             aggregate=self.stats.lat,
                             args={"requests": len(batch)}):
            merged: List = []
            temps: List[float] = []
            budgets: List[int] = []
            for r in batch:
                merged.extend(r.payload)
                temps.extend(r.temps)
                budgets.extend(r.budgets)
            # Collapse to scalars when uniform so plain engines (fake,
            # stubs) that expect scalar settings keep working
            # (collective.py idiom).
            temperature = temps[0] if len(set(temps)) == 1 else temps
            max_tokens = budgets[0] if len(set(budgets)) == 1 else budgets
        first_fail = _fail_t0
        retries_left = (
            self._max_retries if _retries_left is None else _retries_left
        )
        attempt = 0
        while True:
            try:
                out, device_s, dispatch_syncs = self._device_call(
                    sig, merged, temperature, max_tokens, len(batch), anchor
                )
                break
            except BaseException as e:
                if first_fail is None:
                    first_fail = time.monotonic()
                with self._cond:
                    self.stats.engine_errors += 1
                obs_counters.inc("serve.engine_errors")
                if isinstance(e, EngineDead):
                    # Unrecoverable: fail this batch, then take the
                    # scheduler down cleanly (queued futures fail with
                    # SchedulerClosed instead of waiting forever).
                    self._fail_batch(batch, merged, e)
                    self._declare_dead(e)
                    return
                if isinstance(e, EngineHung):
                    # The supervisor already rebuilt the engine: retry
                    # on the fresh one WITHOUT consuming the retry
                    # budget (the one-rebuild budget bounds this loop).
                    with self._cond:
                        self.stats.dispatch_retries += 1
                    obs_counters.inc("serve.dispatch_retries")
                    continue
                if (attempt >= retries_left
                        or resilience.classify_failure(e) == "permanent"):
                    if self._max_retries > 0 and len(batch) > 1:
                        # Bisect: isolate the poison request(s); the
                        # halves inherit the first-failure time so the
                        # recovery histogram spans the whole episode,
                        # and run with a SPENT retry budget — the top
                        # level already retried the union.
                        with self._cond:
                            self.stats.batch_splits += 1
                        obs_counters.inc("serve.batch_splits")
                        mid = len(batch) // 2
                        self._dispatch(batch[:mid], _fail_t0=first_fail,
                                       _retries_left=0)
                        self._dispatch(batch[mid:], _fail_t0=first_fail,
                                       _retries_left=0)
                    else:
                        self._fail_batch(batch, merged, e)
                    return
                attempt += 1
                with self._cond:
                    self.stats.dispatch_retries += 1
                obs_counters.inc("serve.dispatch_retries")
                for r in batch:
                    self._emit(r, "retrying", attempt=attempt,
                               error=f"{type(e).__name__}: {e}")
                time.sleep(resilience.backoff_s(
                    attempt - 1, rng=self._retry_rng
                ))
        if self._engine_unready:
            # First completed dispatch on the rebuilt engine: the
            # /readyz hang window closes here.
            self._engine_unready = False
            obs_alerts.mark_ready("engine")
        device_ms = round(device_s * 1e3, 3)
        self.stats.record_device_time(device_s)
        slo_violations = 0
        with obs_tracer.span("serve.scatter", parent=anchor,
                             aggregate=self.stats.lat,
                             args={"requests": len(batch)}):
            pos = 0
            done_t = time.monotonic()
            for r in batch:
                r.complete(out[pos: pos + r.n_rows])
                pos += r.n_rows
                violated = self.stats.record_completion(
                    done_t - r.submitted_at
                )
                slo_violations += violated
                self._emit(r, "completed", device_ms=device_ms,
                           batch_rows=len(merged),
                           e2e_ms=round((done_t - r.submitted_at) * 1e3, 3))
        recovered = first_fail is not None
        with self._cond:
            self.stats.completed += len(batch)
            self.stats.dispatches += 1
            self.stats.dispatched_rows += len(merged)
            self.stats.slo_violations += slo_violations
            self.stats.dispatch_syncs += dispatch_syncs
            if recovered:
                self.stats.recoveries += 1
        obs_counters.inc("serve.dispatches")
        obs_counters.inc("serve.dispatched_rows", len(merged))
        if recovered:
            obs_counters.inc("serve.recoveries")
            self.stats.record_recovery(time.monotonic() - first_fail)
        if slo_violations:
            obs_counters.inc("serve.slo.violations", slo_violations)

    def _fail_batch(self, batch: List[Request], merged: List,
                    err: BaseException) -> None:
        """Terminal failure for one (possibly split) batch: fail its
        futures, account the dispatch, and REFUND the fair-share charge
        its rows took at selection — the engine never served them, and
        leaving the charge would permanently deflate a crashing
        tenant's own virtual time (its future requests would dispatch
        ahead of healthy tenants exactly because it keeps crashing)."""
        for r in batch:
            r.fail(err)
            self._emit(r, "failed", error=f"{type(err).__name__}: {err}")
        with self._cond:
            self.stats.failed += len(batch)
            self.stats.dispatches += 1
            self.stats.dispatched_rows += len(merged)
            # A failed dispatch's partial host-sync delta is not
            # charged (the engine call died mid-window).
            for r in batch:
                t = self._fair_tenant(r)
                t.served_rows = max(0, t.served_rows - r.n_rows)
        obs_counters.inc("serve.dispatches")
        obs_counters.inc("serve.dispatched_rows", len(merged))

    def _declare_dead(self, err: BaseException) -> None:
        """Engine supervisor verdict: the engine is unrecoverable.
        Close the scheduler from its own dispatch thread — queued
        requests fail with :class:`SchedulerClosed` NOW instead of
        their submitters discovering a dead thread one liveness probe
        at a time.  (``close()`` can still be called later; it joins a
        thread that has already exited.)"""
        # /readyz: an EngineDead verdict is a standing veto (close()
        # clears it — a test's retired scheduler should not pin the
        # process unready forever).
        obs_alerts.mark_unready("scheduler", f"engine dead: {err}")
        with self._cond:
            if self._closed:
                return
            self._closed = True
            for r in self._queue:
                self.stats.cancelled += 1
                self._uncharge_tenant_locked(r)
                r.fail(SchedulerClosed(f"engine declared dead: {err}"))
                self._emit(r, "cancelled", reason="engine_dead")
            self._queue = []
            self._queue_rows = 0
            self._cond.notify_all()

    def _backpressure_probe(self) -> Optional[str]:
        """Read-only /readyz pull probe: unready at (or above) the
        admission watermark so a front door sheds load before queueing
        behind it (advisory peek — no lock, the ints are written under
        ``self._cond`` and read here at most one admission stale)."""
        if self._closed:
            return "scheduler closed"
        if self._queue_rows >= self._max_queue_rows:
            return (f"backpressure: {self._queue_rows} queued rows at "
                    f"the {self._max_queue_rows}-row watermark")
        return None

    def _device_call(self, sig: Tuple, merged: List, temperature, max_tokens,
                     n_requests: int, anchor):
        """One timed engine call under the device lock, optionally
        bounded by the hang watchdog.  Returns ``(rows, device_seconds,
        dispatch_syncs)``; raises whatever the engine raised, or
        :class:`EngineHung` / :class:`EngineDead` on a watchdog trip."""
        device_t0 = time.monotonic()
        with obs_tracer.span("serve.device", parent=anchor,
                             aggregate=self.stats.lat,
                             args={"rows": len(merged),
                                   "requests": n_requests}):
            if self._watchdog_s > 0:
                out, dispatch_syncs = self._watched_engine_call(
                    sig, merged, temperature, max_tokens
                )
            else:
                out, dispatch_syncs = self._engine_call(
                    sig, merged, temperature, max_tokens
                )
        return out, time.monotonic() - device_t0, dispatch_syncs

    def _engine_call(self, sig: Tuple, merged: List, temperature, max_tokens):
        audit = obs_hostsync.auditor()
        dispatch_syncs = 0
        # Snapshot engine + lock into LOCALS before any fault can fire:
        # a watchdog-abandoned worker thread that wakes mid-call must
        # finish against the CONDEMNED engine under the OLD lock — if it
        # re-read self._engine after a supervisor rebuild it would run
        # unserialized against the fresh engine's device state.
        engine = self._engine
        lock = self._device_lock
        with lock:
            # Host-sync delta over the engine call only, read
            # inside the lock so other dispatches through THIS
            # scheduler can never land in the window.  Still a
            # process-wide total: a direct-engine thread or a
            # second scheduler auditing concurrently is counted
            # here too (the can't-split-a-shared-total caveat
            # the round path resolves with rounds_overlapped).
            syncs_before = audit.total() if audit is not None else 0
            # Chaos seam (BCG_TPU_CHAOS, runtime/resilience.py): the
            # injected engine crash / device hang / pool exhaustion
            # land exactly where a real one would — inside the device
            # lock, visible to the watchdog and the retry ladder.
            resilience.inject("serve.dispatch")
            if sig[0] == "json":
                # The device lock guards ONLY the engine call; it
                # is never held together with the queue cond nor
                # across game progress, so the BCG-LOCK-CALL
                # deadlock shape (queue state pinned during a
                # device call) cannot occur here.
                # lint: ignore[BCG-LOCK-CALL]
                out = engine.batch_generate_json(  # lint: ignore[BCG-LOCK-BLOCK] the device lock guards exactly this call
                    merged, temperature=temperature,
                    max_tokens=max_tokens,
                )
            else:
                # lint: ignore[BCG-LOCK-CALL]  (same device-gate-only discipline)
                out = engine.batch_generate(  # lint: ignore[BCG-LOCK-BLOCK] free-text arm of the same device call
                    merged, temperature=temperature,
                    max_tokens=max_tokens, top_p=sig[1],
                )
            if audit is not None:
                dispatch_syncs = audit.total() - syncs_before
        return out, dispatch_syncs

    def _watched_engine_call(self, sig: Tuple, merged: List, temperature,
                             max_tokens):
        """Run the engine call on a watchdog-bounded worker thread (the
        collective-watchdog idiom applied to the device call itself): a
        call that exceeds ``watchdog_s`` is declared hung — its worker
        thread is abandoned (daemon, still holding the OLD device lock)
        and the supervisor decides between a one-time engine rebuild
        (:class:`EngineHung`, retryable) and scheduler death
        (:class:`EngineDead`)."""
        result: Dict[str, Any] = {}
        done = threading.Event()

        def run():
            try:
                result["out"] = self._engine_call(
                    sig, merged, temperature, max_tokens
                )
            except BaseException as e:
                result["err"] = e
            finally:
                done.set()

        worker = threading.Thread(
            target=run, name="bcg-serve-device", daemon=True
        )
        worker.start()
        if not done.wait(self._watchdog_s):
            raise self._supervise_hang()
        if "err" in result:
            raise result["err"]
        return result["out"]

    def _supervise_hang(self) -> BaseException:
        """Engine supervisor: a device call hung past the watchdog.
        With rebuild budget (one per scheduler lifetime) and a factory,
        swap in a FRESH device lock (the hung thread still holds the
        old one and may never release it) and a freshly built engine,
        and hand the dispatch loop a retryable :class:`EngineHung`;
        otherwise the engine is unrecoverable — :class:`EngineDead`."""
        with self._cond:
            can_rebuild = (
                self._rebuilds_left > 0 and self._engine_factory is not None
            )
            if can_rebuild:
                self._rebuilds_left -= 1
                self.stats.engine_rebuilds += 1
        if not can_rebuild:
            return EngineDead(
                f"device call exceeded the {self._watchdog_s:g}s watchdog "
                "and no rebuild budget remains"
            )
        # The hung call's engine (and its lock) are abandoned, not shut
        # down: a shutdown() on a wedged device can hang exactly like
        # the call did.  The replacement lock keeps run_exclusive and
        # later dispatches from queueing behind a thread that may never
        # return.
        self._device_lock = threading.Lock()
        self._engine = self._engine_factory()
        obs_counters.inc("serve.engine_rebuilds")
        # /readyz hang window opens at the watchdog verdict; the first
        # dispatch the fresh engine completes closes it (_dispatch).
        self._engine_unready = True
        obs_alerts.mark_unready(
            "engine", "device call hung; engine rebuilt, retry pending"
        )
        return EngineHung(
            f"device call exceeded the {self._watchdog_s:g}s watchdog; "
            "engine rebuilt, dispatch will be retried"
        )

    def run_exclusive(self, fn):
        """Run ``fn()`` holding the device lock — for proxy paths that
        must call the inner engine directly (e.g. chat-formatted
        ``generate``) without overlapping an in-flight device batch.

        Acquires with a short timeout in a loop that re-reads
        ``self._device_lock``: the engine supervisor swaps the lock
        when it abandons a hung device call, and a caller queued on the
        OLD lock would otherwise wait forever behind a thread that
        never releases it.  A long legitimate device call just loops
        (same lock each pass); a swapped lock is picked up within one
        timeout; a CLOSED scheduler (incl. one _declare_dead took down
        while its wedged lock was never swapped) surfaces
        :class:`SchedulerClosed` instead of spinning on a lock that
        will never be released."""
        while True:
            if self._closed:
                raise SchedulerClosed(
                    "scheduler is shut down; exclusive device access is "
                    "no longer available"
                )
            lock = self._device_lock
            if lock.acquire(timeout=0.1):
                try:
                    return fn()
                finally:
                    lock.release()

    # ------------------------------------------------------------- lifecycle

    @property
    def row_cap(self) -> Optional[int]:
        return self._row_cap

    def queue_depth_rows(self) -> int:
        with self._cond:
            return self._queue_rows

    def snapshot(self) -> Dict[str, Any]:
        pool_stats = getattr(self._engine, "kv_pool_stats", None)
        kv_pool = pool_stats() if callable(pool_stats) else None
        with self._cond:
            return self.stats.snapshot(
                self._row_cap, self._queue_rows, kv_pool=kv_pool,
                tenants=self._tenants,
            )

    def _publish_stats(self) -> None:
        from bcg_tpu_torch.runtime import metrics

        metrics.publish_serve_stats(self.snapshot())

    def close(self, timeout: float = 10.0) -> None:
        """Stop the dispatch loop; fail anything still queued.  Idempotent."""
        with self._cond:
            if not self._closed:
                self._closed = True
                for r in self._queue:
                    self.stats.cancelled += 1
                    self._uncharge_tenant_locked(r)
                    r.fail(SchedulerClosed("scheduler shut down"))
                    self._emit(r, "cancelled", reason="scheduler_shutdown")
                self._queue = []
                self._queue_rows = 0
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        self._publish_stats()
        # Unhook this scheduler from the /readyz state: a closed
        # scheduler is not "unready", it is GONE — the next boot
        # re-registers and starts clean (clears a _declare_dead veto
        # too; a dead production process never reaches close()).
        obs_alerts.clear_readiness("scheduler", "engine", "backpressure")
