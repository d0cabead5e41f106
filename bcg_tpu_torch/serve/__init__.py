"""Continuous-batching async serving subsystem.

The load-bearing step from "batch of experiments" toward a serving
stack: an arrival-driven request queue + dispatch loop
(:mod:`bcg_tpu_torch.serve.scheduler`) replaces the collective barrier's
lockstep semantics — agents' guided/free-text calls enqueue as
independent requests, device batches form on bucket-fill or linger
expiry, KV-budget admission control bounds merged rows, and a crashing
game fails only its own futures.

Switch concurrent sweeps onto it with ``BCG_TPU_SERVE=1``
(:mod:`bcg_tpu_torch.experiments`); :class:`CollectiveEngine` remains the
fallback.
"""

from bcg_tpu_torch.serve.engine import ServingEngine, run_serving_simulations
from bcg_tpu_torch.serve.scheduler import (
    AdmissionDeferred,
    AdmissionRejected,
    Request,
    RequestCancelled,
    Scheduler,
    SchedulerClosed,
    SchedulerStats,
    TenantState,
    derive_retry_after_ms,
    derive_row_cap,
)

__all__ = [
    "AdmissionDeferred",
    "AdmissionRejected",
    "Request",
    "RequestCancelled",
    "Scheduler",
    "SchedulerClosed",
    "SchedulerStats",
    "TenantState",
    "ServingEngine",
    "derive_retry_after_ms",
    "derive_row_cap",
    "run_serving_simulations",
]
