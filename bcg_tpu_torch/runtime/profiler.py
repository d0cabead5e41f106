"""Phase-level wall-clock profiling.

The reference has no timing instrumentation at all (SURVEY.md §5.1).  This
collects per-phase wall time and derives the run's headline metrics —
rounds/sec and agent-decisions/sec — plus optional ``torch.profiler`` traces.

Phase timing DELEGATES to the span tracer (:mod:`bcg_tpu_torch.obs.tracer`):
each ``phase()`` opens a span named after the phase, so with
``BCG_TPU_TRACE=1`` the decide/vote/broadcast phases appear nested under
the orchestrator's ``round`` span in the exported Chrome trace, and the
per-phase accumulation (``phase_seconds``/``phase_counts``, which feed
the metrics CSV) comes out of the same :class:`~bcg_tpu_torch.obs.tracer.
SpanAggregator` machinery instead of a private dict pair.  With tracing
off the span degrades to a timed-only block — the profiler's numbers do
not depend on the tracer being enabled.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

from bcg_tpu_torch.obs.tracer import SpanAggregator, span as _span


class SimulationProfiler:
    def __init__(self):
        self._agg = SpanAggregator()
        self.rounds = 0
        self.decisions = 0  # LLM-made agent decisions (decide + vote calls)
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str):
        with _span(name, aggregate=self._agg):
            yield

    @property
    def phase_seconds(self) -> Dict[str, float]:
        return self._agg.totals()

    @property
    def phase_counts(self) -> Dict[str, int]:
        return self._agg.counts()

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


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str]):
    """Wrap a block in a ``torch.profiler`` capture (CPU activity, plus
    CUDA on a card) exported to ``<log_dir>/trace.json`` (Chrome trace
    format) when a log dir is given."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
