"""Result persistence: JSON + CSV metrics sinks, plus boot-phase
observability.

Byte-compatible with the reference layout (``main.py:792-995``):
``results/json/run_NNN.json`` (config + statistics + per-round trajectory +
final state + message count), ``results/metrics/run_NNN.csv`` (fixed column
order with the reference's rounding map), ``results/logs/run_NNN_log.txt``
(written live by :class:`RunLogger`).  Adds performance fields the
reference lacks (rounds/sec, decisions/sec).

:class:`BootPhaseRecorder` stamps per-phase wall time and device-
allocator readings over engine boot (init → quantize → stack → shard →
first compile), so an on-device ``RESOURCE_EXHAUSTED`` names the phase
it died in — the round-5 14B boot failed inside ``init_params`` twice
with nothing but the raw XLA error to go on.  The last recorder's
phases are mirrored in :data:`LAST_BOOT_PHASES` so ``bench.py`` can
attach them to an error JSON even when the engine object never finished
constructing.
"""

from __future__ import annotations

import csv
import json
import os
import time
from contextlib import contextmanager
from dataclasses import asdict
from datetime import datetime
from typing import Dict, Optional

# Phases of the most recent BootPhaseRecorder (including a partially
# failed boot) — bench.py's error path reads this.
LAST_BOOT_PHASES: Optional[Dict] = None

# Latest serving-scheduler stats snapshot (bcg_tpu/serve): queue depth,
# batch occupancy, linger histogram, admission rejections.  Mirrors the
# LAST_BOOT_PHASES pattern so bench.py / experiment drivers can attach
# the serving profile to their JSON without holding the scheduler object.
LAST_SERVE_STATS: Optional[Dict] = None


def publish_serve_stats(snapshot: Dict) -> None:
    """Record the most recent scheduler stats snapshot (called by
    ``serve.Scheduler`` after each dispatch and at close)."""
    global LAST_SERVE_STATS
    LAST_SERVE_STATS = snapshot


# Latest paged KV-pool snapshot (engine.kv_pool_stats: block headroom,
# radix hit rate, the active paged-attention impl) — published after
# every paged generation call so bench.py can attach it on the ERROR
# path too, where no engine handle survives.
LAST_KV_POOL: Optional[Dict] = None


def publish_kv_pool(snapshot: Optional[Dict]) -> None:
    """Record the most recent paged-pool stats (called by the engine at
    the end of each paged generation call)."""
    global LAST_KV_POOL
    LAST_KV_POOL = snapshot


# Latest guided-sampler self-description (engine.sampler_stats: resolved
# impl, interpret mode, fused-kernel invocation count, resolved KV
# dtype) — published at engine BOOT and after every generation call so
# bench.py's success AND error paths can say which sampler/KV
# configuration actually served (or failed to).
LAST_SAMPLER: Optional[Dict] = None


def publish_sampler(snapshot: Optional[Dict]) -> None:
    """Record the most recent sampler stats (called by the engine at
    boot and at the end of each generation call)."""
    global LAST_SAMPLER
    LAST_SAMPLER = snapshot


# Latest game-telemetry summary (bcg_tpu/obs/game_events: games run/
# completed/converged, rounds, byzantine adoptions, event-sink drops) —
# published by the recorder at game_start/round_end/game_end so
# bench.py can attach the consensus profile on success AND error paths,
# mirroring LAST_SERVE_STATS.  None until a recorder runs (i.e. always
# None unless BCG_TPU_GAME_EVENTS is set).
LAST_GAME_STATS: Optional[Dict] = None


def publish_game_stats(snapshot: Optional[Dict]) -> None:
    """Record the most recent cross-game telemetry summary (called by
    ``obs.game_events.GameEventRecorder``)."""
    global LAST_GAME_STATS
    LAST_GAME_STATS = snapshot


# Latest host-sync auditor summary (obs/hostsync.summary: total/
# attributed device->host transfers, per-site and per-span attribution
# tables, syncs per round) — published by the auditor after each
# generation call and each observed round so bench.py can attach the
# sync profile on success AND error paths, mirroring LAST_SERVE_STATS.
# None until the auditor runs (i.e. always None unless BCG_TPU_HOSTSYNC
# is set).
LAST_HOSTSYNC: Optional[Dict] = None


def publish_hostsync(snapshot: Optional[Dict]) -> None:
    """Record the most recent host-sync summary (called by
    ``obs.hostsync.HostSyncAuditor.publish``)."""
    global LAST_HOSTSYNC
    LAST_HOSTSYNC = snapshot


# Latest fused mega-round summary (engine ``megaround_stats``:
# fused-round count, syncs per fused round, rounds/sec) — published by
# JaxEngine.run_megaround / FakeEngine.run_megaround after every fused
# round so bench.py can attach the ``megaround`` block on success AND
# error paths, mirroring LAST_HOSTSYNC.  None until a fused round runs
# (i.e. always None unless the mega-round is enabled).
LAST_MEGAROUND: Optional[Dict] = None


def publish_megaround(snapshot: Optional[Dict]) -> None:
    """Record the most recent fused mega-round summary (called by the
    engines' ``run_megaround``)."""
    global LAST_MEGAROUND
    LAST_MEGAROUND = snapshot


# Latest compile-cost summary (obs/compile.summary: per-entry compile
# milliseconds, first-compile vs retrace split, cache-entry population,
# retrace-cause records) — published by the observer at every
# trace-cache miss so bench.py can attach the compile profile on
# success AND error paths, mirroring LAST_SERVE_STATS (a first-compile
# death is exactly when this forensics matters most).  None until the
# observer runs (i.e. always None unless BCG_TPU_COMPILE_OBS is set).
LAST_COMPILE_OBS: Optional[Dict] = None


def publish_compile_obs(snapshot: Optional[Dict]) -> None:
    """Record the most recent compile-cost summary (called by
    ``obs.compile.CompileObserver.publish``)."""
    global LAST_COMPILE_OBS
    LAST_COMPILE_OBS = snapshot


# Latest alert-engine summary (obs/alerts.AlertEngine.summary: rules
# evaluated, fired/resolved transition counts, flaps, currently-firing
# rule names) — published at every evaluation cycle so bench.py can
# attach the alerting verdict on success AND error paths, mirroring
# LAST_SERVE_STATS.  None until an engine evaluates (i.e. always None
# unless BCG_TPU_ALERTS is set).
LAST_ALERTS: Optional[Dict] = None


def publish_alerts(snapshot: Optional[Dict]) -> None:
    """Record the most recent alert-engine summary (called by
    ``obs.alerts.AlertEngine.publish``)."""
    global LAST_ALERTS
    LAST_ALERTS = snapshot


def _device_memory():
    """(bytes_in_use, peak_bytes_in_use) as the MAX across all CUDA
    devices (``torch.cuda.memory_allocated`` /
    ``max_memory_allocated``), or (None, None) where no CUDA device is
    present (CPU).

    Max, not device 0: a multi-card run's peak lives on whichever device
    carries the extra share."""
    import torch

    if not torch.cuda.is_available():
        return None, None
    in_use = peak = None
    for dev in range(torch.cuda.device_count()):
        b = torch.cuda.memory_allocated(dev)
        p = torch.cuda.max_memory_allocated(dev)
        in_use = b if in_use is None else max(in_use, b)
        peak = p if peak is None else max(peak, p)
    return in_use, peak


class BootPhaseRecorder:
    """Phase-labelled boot memory/timing breakdown.

    ``peak_bytes_in_use`` is the allocator's cumulative high-water mark
    (TPU allocators expose no per-phase reset), so the phase whose
    reading first jumps IS the phase that set the peak; ``bytes_in_use``
    before/after bounds each phase's resident delta.  A phase that
    raises is still recorded (``failed: true``) before the exception
    propagates — the breakdown survives a mid-boot OOM.
    """

    def __init__(self):
        self.phases: Dict[str, Dict] = {}
        # Publish the (empty) dict immediately: a retry's boot that dies
        # BEFORE its first phase must not leave the previous attempt's
        # breakdown in LAST_BOOT_PHASES to be mislabeled as its own.
        self._publish()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        before, _ = _device_memory()
        try:
            yield
        except BaseException:
            self._record(name, t0, before, failed=True)
            raise
        self._record(name, t0, before)

    def note(self, name: str, seconds: float) -> None:
        """Record an externally timed phase (e.g. the first serving
        call's compile+execute, measured where it runs)."""
        after, peak = _device_memory()
        self.phases[name] = {
            "seconds": round(seconds, 3),
            "bytes_in_use": after,
            "peak_bytes_in_use": peak,
        }
        self._publish()

    def _record(self, name, t0, before, failed: bool = False) -> None:
        after, peak = _device_memory()
        entry = {
            "seconds": round(time.perf_counter() - t0, 3),
            "bytes_in_use_before": before,
            "bytes_in_use": after,
            "peak_bytes_in_use": peak,
        }
        if failed:
            entry["failed"] = True
        self.phases[name] = entry
        self._publish()

    def _publish(self) -> None:
        global LAST_BOOT_PHASES
        LAST_BOOT_PHASES = self.phases

# Q1/Q2 metric families — single source of truth for the CSV column
# sections below AND the track_* gating in build_metrics_payload (a
# field added to one list but not the other would silently escape its
# gate, the exact dead-flag failure the gating exists to fix).
Q1_FIELDS = (
    "convergence_speed",
    "consensus_is_median",
    "consensus_is_extreme",
    "consensus_is_initial",
    "trajectory_stability",
    "final_convergence_metric",
    "convergence_rate_percent",
)
Q2_FIELDS = (
    "centrality",
    "inclusivity",
    "stability_rounds",
    "agreement_rate",
    "consensus_quality_score",
    "avg_distance_from_consensus",
    "byzantine_infiltration",
)

# Fixed CSV column order (reference main.py:911-951).
CSV_FIELDNAMES = [
    "run_number",
    "timestamp",
    # Core outcome
    "consensus_reached",
    "consensus_outcome",
    "honest_agents_won",
    "total_rounds",
    "max_rounds",
    "consensus_value",
    *Q1_FIELDS,
    *Q2_FIELDS,
    # Initial state
    "honest_initial_mean",
    "honest_initial_median",
    "honest_initial_std",
    "honest_final_std",
    # Communication
    "a2a_message_count",
    # Config
    "value_range",
    "network_topology",
    "model_name",
    "byzantine_strategy",
    "honest_agent_type",
    "protocol_type",
    # Performance (new vs reference)
    "wall_clock_seconds",
    "rounds_per_sec",
    "decisions_per_sec",
]

# Rounding map (reference main.py:955-969).
PRECISION_MAP = {
    "final_convergence_metric": 1,
    "convergence_rate_percent": 1,
    "agreement_rate": 1,
    "consensus_quality_score": 1,
    "avg_distance_from_consensus": 3,
    "honest_initial_std": 3,
    "honest_final_std": 3,
    "byzantine_infiltration": 1,
    "centrality": 3,
    "inclusivity": 3,
    "trajectory_stability": 3,
    "honest_initial_mean": 2,
    "honest_initial_median": 2,
    "wall_clock_seconds": 2,
    "rounds_per_sec": 4,
    "decisions_per_sec": 3,
}


def build_metrics_payload(
    run_number: int,
    stats: Dict,
    config,
    message_count: int,
    profile: Optional[Dict] = None,
    timestamp: Optional[str] = None,
) -> Dict:
    """Flat ~38-field metrics dict (reference main.py:852-903).

    The ``metrics.track_*`` flags gate their metric families (the
    reference defines the same flags in METRICS_CONFIG, config.py:71-73,
    but never reads them — here a disabled family's fields are nulled so
    the CSV header stays fixed while the knob actually does something).
    """
    convergence_rate = stats.get("convergence_rate")
    profile = profile or {}
    mcfg = config.metrics
    payload = {
        "run_number": run_number,
        "timestamp": timestamp or datetime.now().strftime("%Y%m%d_%H%M%S"),
        # Core outcome
        "consensus_reached": stats.get("consensus_reached"),
        "consensus_outcome": stats.get("consensus_outcome"),
        "honest_agents_won": stats.get("honest_agents_won"),
        "total_rounds": stats.get("total_rounds"),
        "max_rounds": stats.get("max_rounds"),
        "consensus_value": stats.get("consensus_value"),
        # Q1
        "convergence_speed": stats.get("convergence_speed"),
        "consensus_is_median": stats.get("consensus_is_median"),
        "consensus_is_extreme": stats.get("consensus_is_extreme"),
        "consensus_is_initial": stats.get("consensus_is_initial"),
        "trajectory_stability": stats.get("trajectory_stability"),
        "final_convergence_metric": stats.get("final_convergence_metric"),
        "convergence_rate_percent": (
            convergence_rate * 100 if convergence_rate is not None else None
        ),
        # Q2
        "centrality": stats.get("centrality"),
        "inclusivity": stats.get("inclusivity"),
        "stability_rounds": stats.get("stability_rounds"),
        "agreement_rate": stats.get("agreement_rate"),
        "consensus_quality_score": stats.get("consensus_quality_score"),
        "avg_distance_from_consensus": stats.get("avg_distance_from_consensus"),
        "byzantine_infiltration": stats.get("byzantine_infiltration"),
        # Initial state
        "honest_initial_mean": stats.get("honest_initial_mean"),
        "honest_initial_median": stats.get("honest_initial_median"),
        "honest_initial_std": stats.get("honest_initial_std"),
        "honest_final_std": stats.get("honest_final_std"),
        # Communication
        "a2a_message_count": message_count,
        # Config echo
        "value_range": list(config.game.value_range),
        "network_topology": config.network.topology_type,
        "model_name": config.engine.model_name,
        # The reference reads these two keys from AGENT_CONFIG where they are
        # never defined (main.py:899-900) — always None.  Kept for CSV-column
        # parity, populated with honest defaults.
        "byzantine_strategy": "llm",
        "honest_agent_type": "llm",
        "protocol_type": config.communication.protocol_type,
        # Performance
        "wall_clock_seconds": profile.get("total_seconds"),
        "rounds_per_sec": profile.get("rounds_per_sec"),
        "decisions_per_sec": profile.get("decisions_per_sec"),
    }
    if not mcfg.track_convergence:
        payload.update(dict.fromkeys(Q1_FIELDS))
    if not mcfg.track_byzantine_impact:
        payload.update(dict.fromkeys(Q2_FIELDS))
    if not mcfg.track_communication:
        payload["a2a_message_count"] = None
    return payload


def save_json_results(
    results_dir: str,
    run_number: str,
    config,
    stats: Dict,
    metrics: Dict,
    game,
    message_count: int,
    network_stats: Optional[Dict] = None,
) -> str:
    """results/json/run_NNN.json (reference main.py:813-834)."""
    json_dir = os.path.join(results_dir, "json")
    os.makedirs(json_dir, exist_ok=True)
    path = os.path.join(json_dir, f"run_{run_number}.json")
    results = {
        "run_number": int(run_number),
        "timestamp": metrics["timestamp"],
        "config": asdict(config),
        "statistics": stats,
        "metrics": metrics,
        "rounds": [
            {
                "round": r.round_num,
                "honest_mean": r.honest_mean,
                "honest_std": r.honest_std,
                "convergence_metric": r.convergence_metric,
                "has_consensus": r.has_consensus,
            }
            for r in game.rounds
        ],
        "final_state": game.get_game_state(),
        "a2a_message_count": message_count,
        # Includes channel_dropped/channel_delayed for unreliable
        # channels (comm/lossy_sim.py) so lossy experiments can attribute
        # outcomes to realized losses.
        "network_stats": network_stats or {},
    }
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path


def save_metrics_csv(results_dir: str, run_number: str, metrics: Dict) -> str:
    """results/metrics/run_NNN.csv — one header + one row, with the
    reference's rounding and formatting rules (main.py:905-995):
    None -> "", list -> "a-b", bool -> "True"/"False"."""
    metrics_dir = os.path.join(results_dir, "metrics")
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, f"run_{run_number}.csv")

    row = {field: metrics.get(field) for field in CSV_FIELDNAMES}
    for key, decimals in PRECISION_MAP.items():
        value = row.get(key)
        if value is None:
            row[key] = ""
        else:
            try:
                row[key] = round(float(value), decimals)
            except (TypeError, ValueError):
                row[key] = value
    for key in CSV_FIELDNAMES:
        value = row.get(key)
        if value is None:
            row[key] = ""
        elif isinstance(value, list):
            row[key] = "-".join(str(v) for v in value)
        elif isinstance(value, bool):
            row[key] = str(value)

    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDNAMES)
        writer.writeheader()
        writer.writerow(row)
    return path
