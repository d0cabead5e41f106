"""Phase-level wall-clock profiling.

The reference has no timing instrumentation at all (SURVEY.md §5.1).  This
collects per-phase wall time and derives the run's headline metrics —
rounds/sec and agent-decisions/sec.

The port's copy of ``bcg_tpu/runtime/profiler.py``.  The JAX package
delegates phase timing to its span tracer (``bcg_tpu/obs/tracer.py``),
which the port has not brought over yet (ROADMAP A12); the same
per-phase totals and counts come from a plain accumulator here, so the
numbers the metrics CSV reads are unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict


class SimulationProfiler:
    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self.rounds = 0
        self.decisions = 0  # LLM-made agent decisions (decide + vote calls)
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._totals[name] = self._totals.get(name, 0.0) + time.perf_counter() - t0
            self._counts[name] = self._counts.get(name, 0) + 1

    @property
    def phase_seconds(self) -> Dict[str, float]:
        return dict(self._totals)

    @property
    def phase_counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def count_round(self, num_decisions: int) -> None:
        self.rounds += 1
        self.decisions += num_decisions

    @property
    def total_seconds(self) -> float:
        return time.perf_counter() - self._start

    def summary(self) -> Dict:
        total = self.total_seconds
        return {
            "total_seconds": total,
            "rounds": self.rounds,
            "decisions": self.decisions,
            "rounds_per_sec": self.rounds / total if total > 0 else 0.0,
            "decisions_per_sec": self.decisions / total if total > 0 else 0.0,
            "phase_seconds": self.phase_seconds,
            "phase_counts": self.phase_counts,
        }
