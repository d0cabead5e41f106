"""Observability of the PyTorch port: span tracer, counter/gauge registry,
and the device-cost half — launch census, memory ledger, host-sync
auditor, compile-cost records, telemetry export.

The framework-free modules are the JAX package's, copied with their
imports renamed: ``tracer`` (nestable spans, Chrome trace-event export),
``counters`` (the process-wide counter/gauge/histogram registry),
``ledger`` (device-memory accounts of params / KV cache / prefix cache /
spec slots, ``hbm.*`` gauges), ``export`` (Prometheus exposition, JSONL
event sinks, ``/metrics``), ``fleet``, ``alerts`` and ``game_events``
(the ``BCG_TPU_GAME_EVENTS`` stream).  Three are ported to the PyTorch
engine's seams: ``hostsync`` (``BCG_TPU_HOSTSYNC``: syncs per seam and
per round, and on a card every other synchronizing operation),
``compile`` (``BCG_TPU_COMPILE_OBS``: first calls of new shapes and
``nvcc`` builds; ``BCG_TPU_PROFILE`` windows as ``torch.profiler``
traces) and ``hlo`` (``BCG_TPU_HLO_CENSUS``: the launches of one decode
step by kind).

None of these modules imports torch at module scope.  Enable tracing
with ``BCG_TPU_TRACE=1``.
"""

from bcg_tpu_torch.obs import counters, export, hlo, hostsync, ledger, tracer  # noqa: F401

# game_events is NOT imported eagerly: it pulls game.statistics, which
# flag-only consumers never need; the orchestrator imports it directly.
__all__ = ["counters", "export", "hlo", "hostsync", "ledger", "tracer"]
