"""Process-wide counter/gauge/histogram registry.

One :data:`REGISTRY` per process, holding named monotonic
:class:`Counter`\\ s, settable :class:`Gauge`\\ s, and fixed-bucket
:class:`Histogram`\\ s.  Layers increment into it directly (the serve
scheduler's latency histograms, the engine's compile/retrace
accounting); consumers read it three ways:

* ``snapshot()`` — flat ``{name: value}`` dict of every counter and
  gauge, the form ``bench.py`` attaches to its JSON (success AND error).
  Histograms flatten to ``<name>.count`` / ``<name>.sum`` plus
  CUMULATIVE ``<name>.bucket.le_<bound>`` entries, so one flat dict
  (and the tracer export that embeds it) carries the full distribution;
* ``delta(before)`` — counter movement since an earlier ``snapshot()``,
  the form tests assert on ("this scripted run incremented
  ``engine.retrace.decode_loop`` by exactly 1").  Histogram count and
  bucket entries participate (they are monotonic); ``.sum`` does not —
  a signed-observation histogram (SLO headroom) can move it downward;
* per-instance baselines — a consumer that needs *its own* share of a
  process-wide counter (e.g. one scheduler's latency histograms while
  another may have run earlier in the process) records ``value(name)``
  (or ``Histogram.raw()``) at construction and subtracts at read time.

Counters are strictly monotonic (``inc`` rejects negative amounts):
a counter that can go down is a gauge, and mixing the two breaks
``delta()``'s "movement since" semantics.  Histograms are declared with
their bucket bounds at first use (``histogram(name, bounds)``) and
observed with ``observe()``; bucket-derived quantiles use the
Prometheus ``histogram_quantile`` idiom (linear interpolation within
the bucket, the highest finite bound for the overflow bucket), so p99
precision is set by the declared bounds, not sample storage — a
histogram costs O(buckets) memory forever, never O(observations).
No jax import — this module must stay loadable by flag-only consumers
(bench.py's error path).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

Number = Union[int, float]


class Counter:
    """Named monotonic counter."""

    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value: Number = 0
        self._lock = threading.Lock()

    def inc(self, n: Number = 1) -> None:
        if n < 0:
            raise ValueError(
                f"counter {self.name!r}: inc({n}) — counters are "
                "monotonic; use a gauge for values that go down"
            )
        with self._lock:
            self._value += n

    @property
    def value(self) -> Number:
        return self._value


class Gauge:
    """Named point-in-time value (last set wins)."""

    __slots__ = ("name", "_value")

    def __init__(self, name: str):
        self.name = name
        self._value: Number = 0

    def set(self, value: Number) -> None:
        self._value = value

    @property
    def value(self) -> Number:
        return self._value


def bound_label(bound: float) -> str:
    """Bucket bound -> flat-name fragment (``25`` -> ``le_25``'s ``25``,
    ``2.5`` -> ``2_5``): integers render bare, non-integers replace the
    decimal point so the fragment stays inside the metric-name taxonomy
    (``[a-z0-9_]``).  Bounds are validated non-negative at histogram
    construction, so no sign marker is ever needed."""
    if float(bound) == int(bound):
        return str(int(bound))
    return repr(float(bound)).replace(".", "_")


def quantile_from_counts(
    bounds: Sequence[float], counts: Sequence[Number], q: float
) -> float:
    """Bucket-derived quantile over NON-cumulative per-bucket ``counts``
    (len = len(bounds) + 1; the last entry is the overflow bucket).

    Prometheus ``histogram_quantile`` semantics: linear interpolation
    within the bucket the target rank falls into (lower edge 0 for the
    first bucket), and the highest FINITE bound when the rank lands in
    the overflow bucket — a quantile can never exceed what the declared
    bounds can resolve."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    target = q * total
    prev_bound = 0.0
    cum = 0.0
    for bound, count in zip(bounds, counts):
        cum += count
        if cum >= target and count > 0:
            frac = (target - (cum - count)) / count
            return prev_bound + (float(bound) - prev_bound) * max(0.0, min(1.0, frac))
        prev_bound = float(bound)
    return float(bounds[-1])


class Histogram:
    """Named fixed-bucket histogram: ``observe()`` assigns each value to
    the first bucket whose upper bound admits it (values past the last
    bound land in the implicit overflow/+Inf bucket).  Bounds are fixed
    at construction — quantiles derive from bucket counts, so two
    histograms are mergeable and exposition is O(buckets)."""

    __slots__ = ("name", "bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, name: str, bounds: Iterable[float]):
        self.name = name
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        if not self.bounds:
            raise ValueError(f"histogram {name!r}: needs at least one bucket bound")
        if any(not math.isfinite(b) for b in self.bounds):
            raise ValueError(f"histogram {name!r}: bounds must be finite "
                             "(the +Inf bucket is implicit)")
        if any(b < 0 for b in self.bounds):
            raise ValueError(f"histogram {name!r}: bounds must be non-negative "
                             "(negative observations land in the first bucket)")
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram {name!r}: bounds must be strictly "
                             f"ascending, got {self.bounds}")
        self._counts: List[int] = [0] * (len(self.bounds) + 1)
        self._sum: float = 0.0
        self._count: int = 0
        self._lock = threading.Lock()

    def observe(self, value: Number) -> None:
        v = float(value)
        idx = len(self.bounds)  # overflow unless a bound admits it
        for i, bound in enumerate(self.bounds):
            if v <= bound:
                idx = i
                break
        with self._lock:
            self._counts[idx] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def raw(self) -> Tuple[List[int], float, int]:
        """``(per-bucket counts incl. overflow, sum, count)`` — the
        per-instance-baseline form (a consumer snapshots this at
        construction and subtracts at read time)."""
        with self._lock:
            return list(self._counts), self._sum, self._count

    def cumulative(self) -> List[Tuple[float, int]]:
        """``[(bound, cumulative_count), ...]`` over the finite bounds
        (Prometheus ``_bucket{le=...}`` semantics; the +Inf bucket equals
        ``count``)."""
        with self._lock:
            counts = list(self._counts)
        out = []
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            out.append((bound, cum))
        return out

    def quantile(self, q: float) -> float:
        counts, _, _ = self.raw()
        return quantile_from_counts(self.bounds, counts, q)

    def quantiles(self, qs: Sequence[float] = (0.5, 0.95, 0.99)) -> Dict[str, float]:
        """``{"p50": ..., "p95": ..., "p99": ...}`` (keys derived from
        ``qs``), each bucket-interpolated."""
        counts, _, _ = self.raw()
        return {
            f"p{int(round(q * 100))}": quantile_from_counts(self.bounds, counts, q)
            for q in qs
        }

    def flat(self) -> Dict[str, Number]:
        """Flat snapshot entries: ``<name>.count`` / ``<name>.sum`` /
        cumulative ``<name>.bucket.le_<bound>`` (the +Inf bucket is
        elided — it always equals ``.count``)."""
        with self._lock:
            counts = list(self._counts)
            total, n = self._sum, self._count
        out: Dict[str, Number] = {}
        cum = 0
        for bound, c in zip(self.bounds, counts):
            cum += c
            out[f"{self.name}.bucket.le_{bound_label(bound)}"] = cum
        out[f"{self.name}.sum"] = total
        out[f"{self.name}.count"] = n
        return out


class Registry:
    """Name -> Counter/Gauge/Histogram map; create-on-first-use
    accessors (histograms additionally need bounds at creation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            if name in self._gauges:
                raise TypeError(f"{name!r} is registered as a gauge")
            if name in self._histograms:
                raise TypeError(f"{name!r} is registered as a histogram")
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            if name in self._counters:
                raise TypeError(f"{name!r} is registered as a counter")
            if name in self._histograms:
                raise TypeError(f"{name!r} is registered as a histogram")
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str,
                  bounds: Optional[Iterable[float]] = None) -> Histogram:
        """The named histogram, created with ``bounds`` on first use.
        Later accessors may omit bounds (read access) or repeat the SAME
        bounds; conflicting bounds raise — two call sites disagreeing on
        buckets would silently merge incompatible distributions."""
        with self._lock:
            if name in self._counters:
                raise TypeError(f"{name!r} is registered as a counter")
            if name in self._gauges:
                raise TypeError(f"{name!r} is registered as a gauge")
            h = self._histograms.get(name)
            if h is None:
                if bounds is None:
                    raise KeyError(
                        f"histogram {name!r} does not exist yet — the first "
                        "accessor must declare its bucket bounds"
                    )
                h = self._histograms[name] = Histogram(name, bounds)
            elif bounds is not None and tuple(float(b) for b in bounds) != h.bounds:
                raise ValueError(
                    f"histogram {name!r} already exists with bounds "
                    f"{h.bounds}, not {tuple(bounds)}"
                )
            return h

    def inc(self, name: str, n: Number = 1) -> None:
        self.counter(name).inc(n)

    def set_gauge(self, name: str, value: Number) -> None:
        self.gauge(name).set(value)

    def observe(self, name: str, value: Number) -> None:
        """Observe into an EXISTING histogram (KeyError otherwise — an
        undeclared histogram has no bounds to bucket into)."""
        self.histogram(name).observe(value)

    def value(self, name: str, default: Number = 0) -> Number:
        """Current value of a counter, gauge, or flat histogram entry
        (``<hist>.count`` / ``<hist>.sum`` / ``<hist>.bucket.le_*``);
        ``default`` when the name was never touched (reading must not
        create entries — a baseline capture loop over candidate names
        stays side-effect free)."""
        with self._lock:
            if name in self._counters:
                return self._counters[name].value
            if name in self._gauges:
                return self._gauges[name].value
            hists = list(self._histograms.values())
        for h in hists:
            if name.startswith(h.name + "."):
                return h.flat().get(name, default)
        return default

    def snapshot(self) -> Dict[str, Number]:
        """Flat ``{name: value}`` of every counter, gauge, and
        histogram (flattened — see :meth:`Histogram.flat`), sorted by
        name (stable JSON diffs)."""
        with self._lock:
            out = {n: c.value for n, c in self._counters.items()}
            out.update({n: g.value for n, g in self._gauges.items()})
            hists = list(self._histograms.values())
        for h in hists:
            out.update(h.flat())
        return dict(sorted(out.items()))

    def snapshot_typed(self) -> Dict[str, Dict]:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        — the split the Prometheus exposition
        (:mod:`bcg_tpu_torch.obs.export`) needs, since counter-vs-gauge-vs-
        histogram is a declared TYPE there, not a convention.  Each
        histogram entry carries its cumulative buckets, sum, and
        count."""
        with self._lock:
            counters = dict(
                sorted((n, c.value) for n, c in self._counters.items())
            )
            gauges = dict(
                sorted((n, g.value) for n, g in self._gauges.items())
            )
            hists = sorted(self._histograms.items())
        histograms = {
            name: {
                "buckets": [[b, c] for b, c in h.cumulative()],
                "sum": h.sum,
                "count": h.count,
            }
            for name, h in hists
        }
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def delta(self, before: Dict[str, Number]) -> Dict[str, Number]:
        """COUNTER movement since ``before`` (a prior ``snapshot()``),
        nonzero entries only.  Histogram ``.count`` and ``.bucket.*``
        entries participate (they are monotonic observation counts);
        ``.sum`` does not (signed-observation histograms can move it
        down).  Gauges are excluded: a gauge's change is not "an amount
        of work done" and would pollute assertions like "exactly +1
        retrace"."""
        with self._lock:
            current = {n: c.value for n, c in self._counters.items()}
            hists = list(self._histograms.values())
        for h in hists:
            current.update({
                n: v for n, v in h.flat().items()
                if not n.endswith(".sum")
            })
        out = {
            n: v - before.get(n, 0)
            for n, v in current.items()
            if v - before.get(n, 0) != 0
        }
        return dict(sorted(out.items()))

    def reset(self) -> None:
        """Drop every counter, gauge, and histogram — TEST-ONLY (live
        consumers holding baseline values would see negative deltas)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


# The single process-wide registry.
REGISTRY = Registry()


# Module-level conveniences over REGISTRY (the call-site idiom:
# ``obs_counters.inc("engine.retrace.decode_loop")``).
def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, bounds: Optional[Iterable[float]] = None) -> Histogram:
    return REGISTRY.histogram(name, bounds)


def inc(name: str, n: Number = 1) -> None:
    REGISTRY.inc(name, n)


def set_gauge(name: str, value: Number) -> None:
    REGISTRY.set_gauge(name, value)


def observe(name: str, value: Number) -> None:
    REGISTRY.observe(name, value)


def value(name: str, default: Number = 0) -> Number:
    return REGISTRY.value(name, default)


def snapshot() -> Dict[str, Number]:
    return REGISTRY.snapshot()


def snapshot_typed() -> Dict[str, Dict[str, Number]]:
    return REGISTRY.snapshot_typed()


def delta(before: Dict[str, Number]) -> Dict[str, Number]:
    return REGISTRY.delta(before)


def reset() -> None:
    REGISTRY.reset()
