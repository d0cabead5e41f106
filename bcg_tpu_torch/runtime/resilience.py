"""Chaos seam injection + recovery primitives (``BCG_TPU_CHAOS``).

The paper's only fault model is the Byzantine agents themselves; the
serving tier's fault model is everything else — engine crashes, device
hangs, pool exhaustion, dying disks, frozen ranks.  This module makes
those faults a seeded, spec-driven experimental axis (the
``engine/fault.py`` idiom lifted from response corruption to SEAMS), and
houses the recovery primitives the rest of the stack shares: capped
exponential backoff with jitter, transient-vs-permanent failure
classification, and the supervisor exception types the serving
scheduler's watchdog raises.

Spec grammar (``BCG_TPU_CHAOS``), directives separated by ``;``::

    seed=<int>                       plan-level RNG seed (p-mode draws)
    <kind>@<site>:<when>[:<arg>]     one fault directive

* ``kind`` — ``crash`` (raise :class:`ChaosError`), ``hang`` (sleep
  ``arg`` seconds inside the seam, default 30 — the watchdog's prey),
  ``exhaust`` (raise :class:`~bcg_tpu_torch.engine.paged_kv.PoolExhausted`),
  ``diskfail`` (raise ``OSError`` — the EventSink dead-disk arm),
  ``freeze`` (call :func:`bcg_tpu_torch.obs.fleet.freeze_watermark` — the
  injected-straggler arm, generalized from the fleet scenario's direct
  call).
* ``site`` — an instrumented seam name (:data:`SITES`); unknown sites
  and kind/site mismatches fail at PARSE time: a typo'd chaos spec must
  crash the boot, not silently test nothing.
* ``when`` — comma list of 1-based occurrence indices (``2,5``), an
  open range ``<n>+`` (every pass from the n-th on), or ``p<rate>``
  (seeded Bernoulli per pass, e.g. ``p0.05``).
* ``arg`` — kind-specific (hang seconds).

Example: a crash on the 2nd serve dispatch, a 2-second device hang on
the 4th, pool exhaustion on the 6th::

    BCG_TPU_CHAOS="crash@serve.dispatch:2;hang@serve.dispatch:4:2.0;exhaust@serve.dispatch:6"

Seams call :func:`inject` — a no-op returning immediately when the flag
is unset (read-once, the hostsync idiom), so the instrumented hot paths
carry one predicate when chaos is off.  Every fired fault counts in the
``chaos.injected`` / ``chaos.injected.<kind>`` counters, so a chaos run
is self-describing on ``/metrics`` and in bench JSON like every other
experimental axis.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Dict, List, Optional, Set

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.runtime import envflags

# Instrumented seams and the fault kinds each supports.  A kind that a
# seam's error handling cannot absorb (a ChaosError inside the sink
# writer would kill the drainer thread instead of exercising the
# dead-disk path) is a parse error, not a surprise at fire time.
SITES: Dict[str, Set[str]] = {
    "serve.dispatch": {"crash", "hang", "exhaust"},   # serve/scheduler.py
    "engine.generate": {"crash", "hang", "exhaust"},  # engine/jax_engine.py
    "kvpool.alloc": {"exhaust"},                      # engine/paged_kv.py
    "sink.write": {"diskfail"},                       # obs/export.py EventSink
    "sweep.job": {"crash"},                           # sweep/controller.py
    "fleet.heartbeat": {"freeze"},                    # obs/fleet.py
}

_KINDS = ("crash", "hang", "exhaust", "diskfail", "freeze")


class ChaosError(RuntimeError):
    """The injected engine/job exception — always TRANSIENT by
    definition (the next attempt does not re-fire an occurrence-based
    directive), which is exactly what the retry ladders exist for."""


class EngineHung(RuntimeError):
    """A device call exceeded the serving watchdog and the supervisor
    rebuilt the engine — retry the dispatch on the fresh engine."""


class EngineDead(RuntimeError):
    """A device call hung with no rebuild budget left: the engine is
    unrecoverable and the scheduler must declare itself dead rather
    than hang every future submitter."""


class FaultDirective:
    """One parsed ``<kind>@<site>:<when>[:<arg>]`` entry."""

    __slots__ = ("kind", "site", "occurrences", "from_n", "p", "arg")

    def __init__(self, kind: str, site: str, occurrences: Set[int],
                 from_n: Optional[int], p: Optional[float], arg: float):
        self.kind = kind
        self.site = site
        self.occurrences = occurrences
        self.from_n = from_n
        self.p = p
        self.arg = arg

    def matches(self, n: int, rng: random.Random) -> bool:
        if self.p is not None:
            return rng.random() < self.p
        if self.from_n is not None and n >= self.from_n:
            return True
        return n in self.occurrences


class FaultPlan:
    """Seeded, spec-driven fault schedule over the instrumented seams.

    Thread-safe: seams fire from game threads, the dispatch thread, and
    sink writer threads concurrently; occurrence counting is per SITE
    under one lock (the serving scheduler's single dispatch thread makes
    ``serve.dispatch`` occurrences — fault, retry, fault — strictly
    sequential, which is what makes occurrence-indexed chaos specs
    deterministic)."""

    def __init__(self, directives: List[FaultDirective], seed: int = 0):
        self.directives = directives
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._passes: Dict[str, int] = {}
        self.injected: Dict[str, int] = {}  # "<kind>@<site>" -> count

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        directives: List[FaultDirective] = []
        seed = 0
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("seed="):
                seed = int(part[len("seed="):])
                continue
            try:
                head, rest = part.split("@", 1)
                fields = rest.split(":")
                site = fields[0]
                when = fields[1]
                arg = float(fields[2]) if len(fields) > 2 else 30.0
            except (ValueError, IndexError):
                raise ValueError(
                    f"BCG_TPU_CHAOS directive {part!r}: expected "
                    "'<kind>@<site>:<when>[:<arg>]' or 'seed=<int>'"
                ) from None
            kind = head.strip()
            if kind not in _KINDS:
                raise ValueError(
                    f"BCG_TPU_CHAOS: unknown fault kind {kind!r} "
                    f"(known: {', '.join(_KINDS)})"
                )
            if site not in SITES:
                raise ValueError(
                    f"BCG_TPU_CHAOS: unknown seam {site!r} "
                    f"(known: {', '.join(sorted(SITES))})"
                )
            if kind not in SITES[site]:
                raise ValueError(
                    f"BCG_TPU_CHAOS: kind {kind!r} is not injectable at "
                    f"seam {site!r} (supported there: "
                    f"{', '.join(sorted(SITES[site]))})"
                )
            occurrences: Set[int] = set()
            from_n: Optional[int] = None
            p: Optional[float] = None
            if when.startswith("p"):
                p = float(when[1:])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(
                        f"BCG_TPU_CHAOS: rate {when!r} outside [0, 1]"
                    )
            else:
                for tok in when.split(","):
                    tok = tok.strip()
                    if tok.endswith("+"):
                        n = int(tok[:-1])
                        from_n = n if from_n is None else min(from_n, n)
                    else:
                        occurrences.add(int(tok))
                if not occurrences and from_n is None:
                    raise ValueError(
                        f"BCG_TPU_CHAOS directive {part!r}: empty "
                        "occurrence list"
                    )
            directives.append(
                FaultDirective(kind, site, occurrences, from_n, p, arg)
            )
        plan = cls(directives, seed=seed)
        return plan

    def fire(self, site: str) -> Optional[FaultDirective]:
        """Advance ``site``'s pass counter and return the directive to
        apply on this pass, or None.  First matching directive wins."""
        with self._lock:
            n = self._passes.get(site, 0) + 1
            self._passes[site] = n
            for d in self.directives:
                if d.site == site and d.matches(n, self._rng):
                    key = f"{d.kind}@{site}"
                    self.injected[key] = self.injected.get(key, 0) + 1
                    return d
        return None

    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())


# ------------------------------------------------------------ process plan
_plan_lock = threading.Lock()
_plan: Optional[FaultPlan] = None
_plan_configured = False


def plan() -> Optional[FaultPlan]:
    """The process FaultPlan, parsed once from ``BCG_TPU_CHAOS`` (None
    when unset — the zero-surface default)."""
    global _plan, _plan_configured
    if _plan_configured:
        return _plan
    with _plan_lock:
        if not _plan_configured:
            spec = envflags.get_str("BCG_TPU_CHAOS")
            _plan = FaultPlan.parse(spec) if spec else None
            _plan_configured = True
    return _plan


def reset() -> None:
    """Drop the cached plan + its read-once flag — TEST-ONLY."""
    global _plan, _plan_configured
    with _plan_lock:
        _plan = None
        _plan_configured = False


def inject(site: str) -> None:
    """Chaos seam: apply this pass's scheduled fault at ``site``, if
    any.  The common path (no plan) is one cached-None check."""
    p = plan()
    if p is None:
        return
    d = p.fire(site)
    if d is None:
        return
    obs_counters.inc("chaos.injected")
    obs_counters.inc(f"chaos.injected.{d.kind}")
    if d.kind == "crash":
        raise ChaosError(f"chaos: injected crash at {site}")
    if d.kind == "hang":
        time.sleep(d.arg)
        return
    if d.kind == "exhaust":
        from bcg_tpu_torch.engine.paged_kv import PoolExhausted

        raise PoolExhausted(f"chaos: injected pool exhaustion at {site}")
    if d.kind == "diskfail":
        raise OSError(f"chaos: injected disk failure at {site}")
    if d.kind == "freeze":
        from bcg_tpu_torch.obs import fleet as obs_fleet

        obs_fleet.freeze_watermark()


# ------------------------------------------------------ recovery primitives
def backoff_s(attempt: int, base_s: float = 0.02, cap_s: float = 1.0,
              jitter: float = 0.25,
              rng: Optional[random.Random] = None) -> float:
    """Capped exponential backoff with jitter: ``min(cap, base * 2^n)``
    scaled by ``1 ± jitter``.  The jitter decorrelates retry herds (N
    tenants deferred in the same dispatch window must not all come back
    in the same later one); the cap bounds the recovery-latency tail the
    ``serve.recovery_ms`` histogram measures."""
    delay = min(float(cap_s), float(base_s) * (2.0 ** max(0, attempt)))
    r = rng.uniform(-1.0, 1.0) if rng is not None else random.uniform(-1.0, 1.0)
    return max(0.0, delay * (1.0 + jitter * r))


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` (worth a retry: the condition frees on its own —
    injected chaos, a hung-then-rebuilt engine, pool pressure, deadline
    expiry, I/O flakes) or ``"permanent"`` (retrying re-runs the same
    deterministic failure: config/value errors, a dead scheduler).  The
    sweep controller keys its job-requeue policy on this, and the
    ``job_end`` manifest record carries it either way so a sweep report
    can separate lost-work-from-flakes from genuinely broken configs."""
    from bcg_tpu_torch.engine.paged_kv import PoolExhausted

    if isinstance(exc, EngineDead):
        return "permanent"
    # Deterministic path/permission OSError subclasses recur identically
    # on every attempt (a missing checkpoint dir, an unwritable sweep
    # dir): retrying them burns the whole budget re-running the same
    # failure and labels a broken config "lost work from flakes".
    if isinstance(
        exc,
        (FileNotFoundError, PermissionError, NotADirectoryError,
         IsADirectoryError, FileExistsError),
    ):
        return "permanent"
    if isinstance(
        exc,
        (ChaosError, EngineHung, PoolExhausted, TimeoutError,
         ConnectionError, OSError),
    ):
        return "transient"
    return "permanent"


def stats() -> Optional[Dict[str, int]]:
    """Injected-fault counts by ``<kind>@<site>`` (None when no plan is
    configured) — the bench/test-facing view of ``chaos.injected``."""
    p = _plan if _plan_configured else plan()
    if p is None:
        return None
    # Under the plan lock: seam threads (sink drainer, heartbeat
    # flusher) insert keys concurrently, and an unlocked dict() copy
    # can die mid-iteration — silently dropping bench's faults block
    # on exactly the run that needed it.
    with p._lock:
        return dict(p.injected)
