"""Health & alerting plane: rule-driven evaluation over the metrics
registry, plus the process readiness/liveness state behind the metrics
HTTP server's ``/healthz`` and ``/readyz`` endpoints.

Six PRs of passive measurement made every failure mode *visible*;
nothing in the process *evaluated* it.  This module closes the loop:

* :class:`AlertRule` — a declarative rule over registry names, one of
  four kinds: ``threshold`` (gauge/counter level), ``delta_rate``
  (counter movement per evaluation window, trailing-``*`` wildcard
  sums a family), ``burn_rate`` (SLO violation fraction against an
  error budget, Google-SRE-style fast+slow dual windows), and
  ``staleness`` (epoch-ms heartbeat age and/or a value that stops
  moving).  Rules carry severity (``info``/``warn``/``page``) and a
  ``for_cycles`` debounce.
* :class:`AlertEngine` — evaluates the ruleset over ONE
  ``counters.snapshot()`` per cycle on a periodic daemon thread
  (``BCG_TPU_ALERT_MS``).  Firing->resolved transitions are deduped
  (an alert fires once per episode, re-fire after a resolve counts a
  flap), counted under the registered ``alert.*`` subsystem, exported
  as per-rule ``alert.firing.<rule>`` gauges (which the fleet shard
  plane carries across ranks) plus a labeled ``bcg_alert_firing``
  family on the Prometheus exposition, and emitted as manifest-headed
  JSONL through a bounded :class:`~bcg_tpu_torch.obs.export.EventSink`
  (``BCG_TPU_ALERT_EVENTS``; drops counted in
  ``alert.events_dropped``; ``scripts/alert_report.py`` merges files).
* Readiness/health state — a push API (:func:`mark_ready` /
  :func:`mark_unready`) the serve scheduler drives at its lifecycle
  seams (boot, hang-watchdog window, EngineDead, close) plus pull
  probes (:func:`register_readiness_probe`) for conditions best read
  at request time (backpressure watermark).  Pushed transitions are
  recorded in a bounded history so "did readiness flip during the
  hang window" is checkable without polling.

Enablement follows the hostsync idiom: ``BCG_TPU_ALERTS`` is read
ONCE, on the first surface call; off means zero surface — no ``alert.*``
names registered, no evaluator thread, a byte-identical Prometheus
exposition.  The readiness state itself is plain module state (no
registry names, no threads) so ``/readyz`` serves the gateway PR even
with alerting off.

No jax import — loadable by flag-only consumers.
"""

from __future__ import annotations

import atexit
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from bcg_tpu_torch.obs import counters as obs_counters, export as obs_export
from bcg_tpu_torch.obs import fleet as obs_fleet
from bcg_tpu_torch.runtime import envflags

SEVERITIES = ("info", "warn", "page")
RULE_KINDS = ("threshold", "delta_rate", "burn_rate", "staleness")
_RULE_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")


@dataclass(frozen=True)
class AlertRule:
    """One declarative alert rule over registry names.

    Field use by kind:

    * ``threshold`` — fires while ``metric``'s current value is ``op``
      (``gt``/``lt``) ``value``.  An absent metric never fires (absence
      is the ``staleness`` kind's business).
    * ``delta_rate`` — fires when ``metric`` moved by more than
      ``value`` over the last evaluation window; a trailing ``*`` sums
      the matching family (``engine.retrace.*``).  ``unless_metric``
      (same wildcard syntax) suppresses the rule when THAT family also
      moved in the window — "injected without recovered" composites.
    * ``burn_rate`` — violation fraction ``delta(metric) /
      delta(requests_metric)`` over BOTH a fast (``fast_cycles``) and a
      slow (``slow_cycles``) window; fires while both fractions exceed
      ``budget * burn_factor`` and the denominator moved.  Early in a
      run the slow window clamps to "since engine start".
    * ``staleness`` — with ``max_age_ms`` > 0: fires while ``metric``
      is a nonzero epoch-ms gauge older than ``max_age_ms`` (heartbeat
      age).  With ``stall_cycles`` > 0: fires once the metric is
      present but unchanged for that many consecutive cycles
      (watermark stall).  Either arm trips the rule.

    ``for_cycles`` debounces: the condition must hold for that many
    ADDITIONAL consecutive cycles before the rule fires (0 = fire on
    the first true cycle).  Firing is an edge, not a level: one
    ``fired`` count + one JSONL record per episode; a re-fire after a
    resolve counts ``alert.flaps``.
    """

    name: str
    kind: str
    severity: str = "warn"
    summary: str = ""
    for_cycles: int = 0
    metric: str = ""
    op: str = "gt"
    value: float = 0.0
    unless_metric: str = ""
    requests_metric: str = ""
    budget: float = 0.0
    burn_factor: float = 1.0
    fast_cycles: int = 1
    slow_cycles: int = 5
    max_age_ms: float = 0.0
    stall_cycles: int = 0

    def __post_init__(self):
        if not _RULE_NAME_RE.match(self.name):
            raise ValueError(f"alert rule name {self.name!r} must match "
                             f"{_RULE_NAME_RE.pattern}")
        if self.kind not in RULE_KINDS:
            raise ValueError(f"alert rule {self.name}: unknown kind "
                             f"{self.kind!r} (one of {RULE_KINDS})")
        if self.severity not in SEVERITIES:
            raise ValueError(f"alert rule {self.name}: unknown severity "
                             f"{self.severity!r} (one of {SEVERITIES})")
        if self.op not in ("gt", "lt"):
            raise ValueError(f"alert rule {self.name}: op must be gt|lt")
        if self.kind == "staleness" and not (self.max_age_ms > 0
                                             or self.stall_cycles > 0):
            raise ValueError(f"alert rule {self.name}: staleness needs "
                             "max_age_ms and/or stall_cycles")


def build_default_rules() -> List[AlertRule]:
    """The stock ruleset: one rule per known failure mode the existing
    observability planes measure but nothing evaluated.  Severity
    ``page`` feeds the ``/healthz`` verdict; ``warn`` is the
    dashboards-and-timeline tier."""
    return [
        AlertRule(
            name="slo_burn", kind="burn_rate", severity="page",
            metric="serve.slo.violations", requests_metric="serve.requests",
            budget=0.05, burn_factor=2.0, fast_cycles=1, slow_cycles=5,
            summary="SLO violation fraction burning >2x the 5% error "
                    "budget in both fast and slow windows",
        ),
        AlertRule(
            name="engine_errors", kind="delta_rate", severity="page",
            metric="serve.engine_errors",
            summary="engine call failures in the evaluation window",
        ),
        AlertRule(
            name="engine_rebuilt", kind="delta_rate", severity="warn",
            metric="serve.engine_rebuilds",
            summary="hang-watchdog rebuilt the engine (recovery activity)",
        ),
        AlertRule(
            name="dispatch_retries", kind="delta_rate", severity="warn",
            metric="serve.dispatch_retries",
            summary="dispatch retry ladder engaged (recovery activity)",
        ),
        AlertRule(
            name="events_dropped", kind="threshold", severity="warn",
            metric="serve.events_dropped", op="gt", value=0,
            summary="lifecycle event sink dropped records (queue "
                    "overflow or dead disk)",
        ),
        AlertRule(
            name="retrace_storm", kind="delta_rate", severity="warn",
            metric="engine.retrace.*", for_cycles=1,
            summary="steady-state retraces: jit cache misses after warmup",
        ),
        AlertRule(
            name="hbm_unaccounted", kind="threshold", severity="warn",
            metric="hbm.unaccounted_bytes", op="gt", value=64 * 2 ** 20,
            summary="allocator-vs-ledger drift above 64 MiB (leak or "
                    "unledgered buffer)",
        ),
        AlertRule(
            name="pool_headroom", kind="threshold", severity="warn",
            metric="kvpool.headroom_bytes", op="lt", value=1,
            summary="paged-KV free-block headroom exhausted",
        ),
        AlertRule(
            name="heartbeat_stale", kind="staleness", severity="page",
            metric="fleet.heartbeat_ms", max_age_ms=15000.0,
            summary="fleet heartbeat older than 15s",
        ),
        AlertRule(
            name="watermark_stall", kind="staleness", severity="warn",
            metric="fleet.watermark", stall_cycles=30,
            summary="shard watermark unchanged for 30 evaluation cycles",
        ),
        AlertRule(
            name="fleet_straggler", kind="threshold", severity="warn",
            metric="fleet.stragglers", op="gt", value=0,
            summary="fleet straggler verdict (lagging watermark or "
                    "stale heartbeat)",
        ),
        AlertRule(
            name="chaos_unrecovered", kind="delta_rate", severity="page",
            metric="chaos.injected", unless_metric="serve.recoveries",
            summary="chaos faults injected with no recovery activity "
                    "in the same window",
        ),
    ]


class _RuleState:
    __slots__ = ("consecutive_true", "firing", "fired_count",
                 "stall_count", "last_sample")

    def __init__(self):
        self.consecutive_true = 0
        self.firing = False
        self.fired_count = 0
        self.stall_count = 0
        self.last_sample: Optional[float] = None


class AlertEngine:
    """Evaluates a ruleset over ONE registry snapshot per cycle.

    All ``alert.*`` registry names are created at CONSTRUCTION, not on
    first transition — an enabled-but-quiet process still advertises
    the alerting surface, and the exact-bytes zero-surface test has a
    definite complement to pin."""

    def __init__(self, rules: Optional[List[AlertRule]] = None,
                 period_ms: Optional[int] = None):
        self.rules = list(rules) if rules is not None else build_default_rules()
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {sorted(names)}")
        self.period_ms = (envflags.get_int("BCG_TPU_ALERT_MS")
                          if period_ms is None else period_ms)
        obs_counters.counter("alert.evaluations")
        obs_counters.counter("alert.fired")
        obs_counters.counter("alert.resolved")
        obs_counters.counter("alert.flaps")
        obs_counters.counter("alert.events_dropped")
        obs_counters.set_gauge("alert.rules", len(self.rules))
        for r in self.rules:
            obs_counters.set_gauge(f"alert.firing.{r.name}", 0)
        self._states = {r.name: _RuleState() for r in self.rules}
        self._lock = threading.Lock()
        # Recent snapshots, newest last; sized for the largest burn-rate
        # slow window (+1 so a k-cycle delta has a base to diff against).
        depth = max([r.slow_cycles for r in self.rules
                     if r.kind == "burn_rate"] + [1]) + 1
        self._history: "deque" = deque(maxlen=depth)
        self.evaluations = 0
        self.fired = 0
        self.resolved = 0
        self.flaps = 0
        self._sink: Optional[obs_export.EventSink] = None
        path = envflags.get_str("BCG_TPU_ALERT_EVENTS")
        if path:
            self._sink = obs_export.EventSink(
                path, drop_counter="alert.events_dropped",
                manifest=obs_export.run_manifest(kind="alert"),
            )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._run, name="bcg-alert-eval", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.period_ms / 1000.0):
            self.evaluate_once()
            self.publish()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            doomed, self._thread = self._thread, None
        if doomed is not None:
            doomed.join(timeout=10.0)
        if self._sink is not None:
            self._sink.close()
            self._sink = None

    # ----------------------------------------------------------- evaluation
    def evaluate_once(self, now_ms: Optional[float] = None) -> None:
        """One evaluation cycle over one snapshot.  Also the seam the
        straggler plane rides: a fleet-enabled process gets its
        (rate-limited) ``check_stragglers`` verdict refreshed here, so
        the ``fleet_straggler`` rule alerts on it instead of the gauge
        waiting for a reader."""
        if obs_fleet.enabled():
            obs_fleet.check_stragglers()
        if now_ms is None:
            # Heartbeat gauges are epoch-ms BY CONTRACT (cross-process
            # comparisons) — age must diff against the same clock.
            now_ms = time.time() * 1e3
        with self._lock:
            snap = obs_counters.snapshot()
            self._history.append(snap)
            self.evaluations += 1
            obs_counters.inc("alert.evaluations")
            for rule in self.rules:
                cond, measured = self._check(rule, snap, now_ms)
                st = self._states[rule.name]
                st.consecutive_true = st.consecutive_true + 1 if cond else 0
                if st.consecutive_true > rule.for_cycles and not st.firing:
                    st.firing = True
                    if st.fired_count:
                        self.flaps += 1
                        obs_counters.inc("alert.flaps")
                    st.fired_count += 1
                    self.fired += 1
                    obs_counters.inc("alert.fired")
                    obs_counters.set_gauge(f"alert.firing.{rule.name}", 1)
                    self._emit("firing", rule, measured)
                elif not cond and st.firing:
                    st.firing = False
                    self.resolved += 1
                    obs_counters.inc("alert.resolved")
                    obs_counters.set_gauge(f"alert.firing.{rule.name}", 0)
                    self._emit("resolved", rule, measured)

    @staticmethod
    def _sample(snap: Dict[str, float], pattern: str
                ) -> Tuple[bool, float]:
        """(present, value) of a metric — a trailing ``*`` sums the
        matching family (present when any member exists)."""
        if pattern.endswith("*"):
            prefix = pattern[:-1]
            hits = [v for k, v in snap.items() if k.startswith(prefix)]
            return bool(hits), float(sum(hits))
        if pattern in snap:
            return True, float(snap[pattern])
        return False, 0.0

    def _delta(self, pattern: str, cycles: int) -> Tuple[bool, float]:
        """Movement of a metric over the last ``cycles`` evaluation
        windows (clamped to history depth).  The FIRST cycle has no
        base snapshot, so nothing "moves" — pre-engine counts can't
        fire a rate rule at boot."""
        if len(self._history) < 2:
            return False, 0.0
        base_idx = max(0, len(self._history) - 1 - cycles)
        _, cur = self._sample(self._history[-1], pattern)
        _, base = self._sample(self._history[base_idx], pattern)
        return True, cur - base

    def _check(self, rule: AlertRule, snap: Dict[str, float],
               now_ms: float) -> Tuple[bool, float]:
        if rule.kind == "threshold":
            present, v = self._sample(snap, rule.metric)
            if not present:
                return False, 0.0
            cond = v > rule.value if rule.op == "gt" else v < rule.value
            return cond, v
        if rule.kind == "delta_rate":
            ok, d = self._delta(rule.metric, 1)
            if not ok or d <= rule.value:
                return False, d
            if rule.unless_metric:
                _, ud = self._delta(rule.unless_metric, 1)
                if ud > 0:
                    return False, d
            return True, d
        if rule.kind == "burn_rate":
            ok_f, viol_f = self._delta(rule.metric, rule.fast_cycles)
            _, req_f = self._delta(rule.requests_metric, rule.fast_cycles)
            _, viol_s = self._delta(rule.metric, rule.slow_cycles)
            _, req_s = self._delta(rule.requests_metric, rule.slow_cycles)
            if not ok_f or req_f <= 0 or req_s <= 0:
                return False, 0.0
            burn = rule.budget * rule.burn_factor
            frac_f, frac_s = viol_f / req_f, viol_s / req_s
            return (frac_f > burn and frac_s > burn), frac_f
        # staleness
        st = self._states[rule.name]
        present, v = self._sample(snap, rule.metric)
        stale = False
        measured = 0.0
        if present and rule.max_age_ms > 0 and v > 0:
            age_ms = now_ms - v  # lint: ignore[BCG-TIME-WALL]
            measured = age_ms
            stale = age_ms > rule.max_age_ms
        if rule.stall_cycles > 0:
            if present and st.last_sample is not None and v == st.last_sample:
                st.stall_count += 1
            else:
                st.stall_count = 0
            st.last_sample = v if present else None
            if st.stall_count >= rule.stall_cycles:
                stale = True
                measured = float(st.stall_count)
        return stale, measured

    def _emit(self, state: str, rule: AlertRule, measured: float) -> None:
        if self._sink is not None:
            self._sink.emit(
                "alert", rule=rule.name, severity=rule.severity,
                state=state, kind=rule.kind, value=round(measured, 6),
                summary=rule.summary,
            )

    # ------------------------------------------------------------ inspection
    def firing(self) -> List[str]:
        with self._lock:
            return sorted(n for n, st in self._states.items() if st.firing)

    def page_firing(self) -> List[str]:
        sev = {r.name: r.severity for r in self.rules}
        return [n for n in self.firing() if sev[n] == "page"]

    def fired_by_rule(self) -> Dict[str, int]:
        """Episode counts per rule name (fired-at-least-once rules
        only) — the perf gate's 'expected rules actually fired' oracle."""
        with self._lock:
            return {n: st.fired_count for n, st in self._states.items()
                    if st.fired_count}

    def summary(self) -> Dict[str, Any]:
        firing = self.firing()
        sev = {r.name: r.severity for r in self.rules}
        return {
            "enabled": True,
            "period_ms": self.period_ms,
            "rules": len(self.rules),
            "evaluations": self.evaluations,
            "fired": self.fired,
            "resolved": self.resolved,
            "flaps": self.flaps,
            "firing": firing,
            "page_firing": [n for n in firing if sev[n] == "page"],
            "fired_by_rule": self.fired_by_rule(),
        }

    def publish(self) -> None:
        from bcg_tpu_torch.runtime import metrics

        metrics.publish_alerts(self.summary())


# --------------------------------------------------------- module surface
_config_lock = threading.Lock()
_engine: Optional[AlertEngine] = None
_configured = False


def _firing_blocks(labels: str) -> List[Tuple[str, List[str]]]:
    """Extra Prometheus exposition blocks: the labeled
    ``bcg_alert_firing{rule="..."}`` family, one sample per rule (0
    when quiet — a scraper sees the full rule catalog, not just
    incidents).  Installed as the export module's extra-blocks
    provider only while an engine is live, so the alerts-off
    exposition stays byte-identical."""
    eng = _engine
    if eng is None:
        return []
    firing = set(eng.firing())
    metric = "bcg_alert_firing"
    lines = [
        f"# HELP {metric} bcg_tpu alert rule firing state (1=firing)",
        f"# TYPE {metric} gauge",
    ]
    for rule in eng.rules:
        body = f'{labels},rule="{rule.name}"' if labels else f'rule="{rule.name}"'
        lines.append(
            f"{metric}{{{body}}} {1 if rule.name in firing else 0}"
        )
    return [(metric, lines)]


def _ensure() -> Optional[AlertEngine]:
    global _engine, _configured
    if _configured:
        return _engine
    with _config_lock:
        if not _configured:
            if envflags.get_bool("BCG_TPU_ALERTS"):
                eng = AlertEngine()
                obs_export.set_extra_blocks_provider(_firing_blocks)
                eng.start()
                _engine = eng
                # Drain the JSONL tail on normal interpreter exit —
                # the evaluator is a daemon thread.
                atexit.register(reset)
            _configured = True
    return _engine


def maybe_start() -> Optional[AlertEngine]:
    """Read ``BCG_TPU_ALERTS`` once and start the evaluator when set.
    Called from scheduler boot — cheap no-op on every later call (and
    with the flag unset: zero surface, see module docstring)."""
    return _ensure()


def engine() -> Optional[AlertEngine]:
    return _engine if _configured else _ensure()


def enabled() -> bool:
    return engine() is not None


def evaluate_now() -> None:
    """Force one evaluation cycle synchronously (gates and tests drive
    deterministic cycles this way; the periodic thread stays the
    production cadence)."""
    e = engine()
    if e is not None:
        e.evaluate_once()
        e.publish()


def summary() -> Optional[Dict[str, Any]]:
    e = engine()
    return e.summary() if e is not None else None


def reset() -> None:
    """Stop the engine and drop the read-once cache — TEST-ONLY (also
    the atexit drain hook).  Registered ``alert.*`` names persist in
    the in-process registry (registries don't unregister); the
    zero-surface pin runs in a subprocess for exactly this reason."""
    global _engine, _configured
    with _config_lock:
        doomed, _engine = _engine, None
        _configured = False
    # stop() joins the evaluator thread — dispatch it OUTSIDE
    # _config_lock so a slow drain can never wedge configuration.
    if doomed is not None:
        obs_export.set_extra_blocks_provider(None)
        doomed.stop()


# ------------------------------------------------- readiness / health state
# Plain module state, deliberately independent of BCG_TPU_ALERTS: the
# gateway consumes /readyz whether or not alert evaluation is on, and
# keeping it registry-free preserves the zero-surface exposition pin.
_health_lock = threading.Lock()
_unready: Dict[str, str] = {}
_probes: Dict[str, Callable[[], Optional[str]]] = {}
_transitions: "deque" = deque(maxlen=256)
_last_recorded: Optional[Tuple[bool, Tuple[Tuple[str, str], ...]]] = None


def _record_locked() -> None:
    ready = not _unready
    key = (ready, tuple(sorted(_unready.items())))
    global _last_recorded
    if key == _last_recorded:
        return
    _last_recorded = key
    _transitions.append({
        "ts": time.time(),  # epoch by contract: merged across ranks
        "ready": ready,
        "reasons": dict(_unready),
    })


def mark_ready(component: str) -> None:
    """Push: ``component`` no longer objects to readiness."""
    with _health_lock:
        _unready.pop(component, None)
        _record_locked()


def mark_unready(component: str, reason: str) -> None:
    """Push: ``component`` vetoes readiness (hang window, EngineDead,
    scheduler closed).  Recorded in the bounded transition history."""
    with _health_lock:
        _unready[component] = reason
        _record_locked()


def register_readiness_probe(component: str,
                             probe: Callable[[], Optional[str]]) -> None:
    """Pull: ``probe`` is called at each readiness READ and returns a
    veto reason or None — for conditions best sampled at request time
    (backpressure watermark) rather than evented."""
    with _health_lock:
        _probes[component] = probe


def clear_readiness(*components: str) -> None:
    """Drop pushed state and probes for ``components`` (scheduler
    close unhooks itself so the next boot starts clean)."""
    with _health_lock:
        for c in components:
            _unready.pop(c, None)
            _probes.pop(c, None)
        _record_locked()


def readiness() -> Tuple[bool, Dict[str, Any]]:
    """``/readyz`` verdict: ready iff no component vetoes — pushed
    state (hang window, EngineDead, closed) merged with live probe
    reads (backpressure)."""
    with _health_lock:
        reasons = dict(_unready)
        probes = list(_probes.items())
    for name, probe in probes:  # probes read scheduler attrs; never under our lock
        why = probe()
        if why:
            reasons[name] = why
    ready = not reasons
    return ready, {
        "status": "ready" if ready else "unready",
        "reasons": reasons,
    }


def readiness_history() -> List[Dict[str, Any]]:
    """The bounded pushed-transition log (newest last) — lets a gate
    assert "readiness flipped during the hang window and back" without
    having to poll inside it."""
    with _health_lock:
        return list(_transitions)


def health() -> Tuple[bool, Dict[str, Any]]:
    """``/healthz`` verdict: the process is up (trivially, it
    answered) and no page-severity alert is firing.  With alerting off
    the second clause is vacuously true."""
    e = engine()
    pages = e.page_firing() if e is not None else []
    ok = not pages
    return ok, {
        "status": "ok" if ok else "failing",
        "page_firing": pages,
    }


def reset_readiness() -> None:
    """Clear pushed state, probes, and the transition history —
    TEST-ONLY."""
    global _last_recorded
    with _health_lock:
        _unready.clear()
        _probes.clear()
        _transitions.clear()
        _last_recorded = None
