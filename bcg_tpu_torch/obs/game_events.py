"""Consensus-game telemetry: a structured per-round event stream plus
live ``game.*`` counters/gauges.

Every other instrument in :mod:`bcg_tpu_torch.obs` measures the *engine*
(spans, compile/retrace counters, HLO census, HBM ledger); this module
measures the *game* — the paper's actual subject.  When
``BCG_TPU_GAME_EVENTS=<path>`` is set, each :class:`~bcg_tpu_torch.runtime.
orchestrator.BCGSimulation` gets a :class:`GameEventRecorder` that
emits one JSONL record per round event through the same bounded-queue /
writer-thread :class:`~bcg_tpu_torch.obs.export.EventSink` idiom as
``BCG_TPU_SERVE_EVENTS`` — an emit never blocks the round loop, and a
full queue drops the OLDEST records counted in ``game.events_dropped``.
The file's first line is a run manifest (run id, schema version, flag
overrides, preset), so ``scripts/consensus_report.py`` can merge many
files from a sweep mechanically.

Record schema (``schema_version`` in the manifest; one JSON object per
line, every record carries ``ts`` + ``event`` + ``game`` + ``round``):

* ``game_start`` — per-game config: agents split, value range,
  threshold, max rounds, topology, seed, backend/model.
* ``round_start`` — round began.
* ``decision`` — one agent's decide-phase outcome: ``agent``, ``role``
  (``honest``/``byzantine``), ``value`` (None = abstain), ``outcome``
  (``valid`` / ``fallback`` = sequential-retry success / ``invalid`` =
  every attempt failed).
* ``deliveries`` — the topology-masked inbox of one agent for the
  round: ``agent``, ``senders`` (the proposals that actually arrived —
  ring/grid/custom masks and lossy channels show up here) and, when the
  exchange path records them, ``values`` (what this receiver saw from
  each sender — equivocation shows up as the same sender's value
  differing across receivers' records).
* ``vote`` — one agent's termination vote (``stop``/``continue``/
  ``abstain``).
* ``round_end`` — the :func:`~bcg_tpu_torch.game.statistics.round_record`
  summary (same shape as saved ``rounds_data``) merged with
  :func:`~bcg_tpu_torch.game.statistics.round_convergence` (distinct honest
  values, value spread, margin vs threshold, byzantine influence) and
  ``duration_ms``.
* ``game_end`` — converged?, rounds, termination reason, cumulative
  byzantine influence.

Live metrics (registered ONLY while a recorder exists — the
disabled-by-default path adds no counters, no threads): counters
``game.rounds`` / ``game.rounds.consensus`` / ``game.decisions`` /
``game.decisions.invalid`` / ``game.decisions.fallback`` /
``game.votes.stop`` / ``game.votes.continue`` / ``game.votes.abstain``
/ ``game.deliveries`` / ``game.byzantine.adoptions`` / ``game.games``
/ ``game.games.completed`` / ``game.games.converged``; gauges
``game.distinct_honest_values`` / ``game.value_spread`` /
``game.margin_vs_threshold``; histogram ``game.round_ms``.  All are
visible on the Prometheus endpoint (``BCG_TPU_METRICS_PORT``) mid-run.

No jax import — loadable by flag-only consumers.
"""

from __future__ import annotations

import atexit
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from bcg_tpu_torch.game.statistics import round_convergence, round_record
from bcg_tpu_torch.obs import (
    counters as obs_counters,
    export as obs_export,
    fleet as obs_fleet,
)
from bcg_tpu_torch.runtime import envflags

# Round wall-time bucket bounds (ms): FakeEngine rounds run ~1-50 ms;
# real TPU rounds span hundreds of ms (warm decode) to tens of seconds
# (cold compile) — the top bound keeps p99 resolvable either way.
_ROUND_MS_BUCKETS = (5, 10, 25, 50, 100, 250, 1000, 5000, 30000)

_sink_lock = threading.Lock()
_sink: Optional[obs_export.EventSink] = None
_sink_configured = False


def _ensure_sink(preset: Optional[str] = None) -> Optional[obs_export.EventSink]:
    """The process-wide game-event sink (None when
    ``BCG_TPU_GAME_EVENTS`` is unset).  Created once, on the first
    recorder; the manifest header carries the creating game's preset."""
    global _sink, _sink_configured
    if _sink_configured:
        return _sink
    with _sink_lock:
        if not _sink_configured:
            path = envflags.get_str("BCG_TPU_GAME_EVENTS")
            if path:
                _sink = obs_export.EventSink(
                    path,
                    drop_counter="game.events_dropped",
                    manifest=obs_export.run_manifest(
                        kind="game", preset=preset
                    ),
                )
                # Drain on normal interpreter exit (daemon writer thread).
                atexit.register(reset_sink)
            _sink_configured = True
    return _sink


def reset_sink() -> None:
    """Drop the cached sink + its read-once flag — TEST-ONLY (and the
    atexit drain)."""
    global _sink, _sink_configured
    with _sink_lock:
        if _sink is not None:
            _sink.close()
        _sink = None
        _sink_configured = False


# Cross-game aggregate behind bench.py's game_stats attachment — the
# serving LAST_SERVE_STATS idiom for game telemetry.
_agg_lock = threading.Lock()
_agg = {
    "games": 0,
    "games_completed": 0,
    "games_converged": 0,
    "rounds": 0,
    "byzantine_adoptions": 0,
}


def summary() -> Optional[Dict[str, Any]]:
    """Cumulative game-telemetry summary for this process, or None when
    no recorder ever ran (bench attaches this on success AND error)."""
    with _agg_lock:
        if not _agg["games"]:
            return None
        out = dict(_agg)
    out["events_dropped"] = obs_counters.value("game.events_dropped")
    return out


def _reset_aggregate() -> None:
    """TEST-ONLY: zero the cross-game aggregate."""
    with _agg_lock:
        for k in _agg:
            _agg[k] = 0


def maybe_recorder(sim) -> Optional["GameEventRecorder"]:
    """A recorder for ``sim`` (a BCGSimulation) when
    ``BCG_TPU_GAME_EVENTS`` is set; None otherwise.  The None path is
    the whole disabled story: no sink, no thread, no ``game.*``
    registry entries, and the orchestrator's only cost is one
    ``is not None`` per emission site."""
    if not envflags.get_str("BCG_TPU_GAME_EVENTS"):
        return None
    return GameEventRecorder(sim)


class GameEventRecorder:
    """Per-simulation emitter of game events + live ``game.*`` metrics.

    Construction emits ``game_start`` and publishes the aggregate; the
    orchestrator calls the event methods from its round loop — each is
    a dict build + bounded-queue append (the sink's writer thread owns
    disk latency).
    """

    def __init__(self, sim):
        cfg = sim.config
        self._game_id = f"{sim.run_number}_g{sim._sim_uid}"
        # Sweep-tier job identity: rides game_start/game_end so resume
        # logic and report merges can key on the JOB (stable across
        # processes) instead of the per-process game id.
        self._job_id = getattr(sim, "sweep_job_id", None)
        self._threshold = float(sim.game.consensus_threshold)
        self._honest_ids = tuple(
            aid for aid, st in sim.game.agents.items() if not st.is_byzantine
        )
        self._byz_ids = tuple(
            aid for aid, st in sim.game.agents.items() if st.is_byzantine
        )
        # Game-only runs (FakeEngine, no serve layer) never pass the
        # engine/scheduler boot sites that start the metrics endpoint or
        # the fleet metric-shard flusher — kick both idempotent starters
        # here, BEFORE the sink exists, so the run manifest can carry
        # the rank's actual bound metrics_port and game.* metrics are
        # scrapeable/shardable mid-run.
        obs_export.maybe_start_http_server()
        obs_fleet.maybe_start_shard_writer()
        self._sink = _ensure_sink(preset=cfg.engine.model_name)
        self._round_t0: Optional[float] = None
        # Previous round's per-agent values + byzantine proposals — the
        # byzantine_influence inputs (adoption is measured against what
        # the adversary BROADCAST last round).
        self._prev_values: Dict[str, Any] = {
            aid: st.current_value for aid, st in sim.game.agents.items()
        }
        self._prev_byz_proposals: List[int] = []
        self._influence_total = 0
        self._ended = False
        self._round_hist = obs_counters.histogram(
            "game.round_ms", _ROUND_MS_BUCKETS
        )
        obs_counters.inc("game.games")
        with _agg_lock:
            _agg["games"] += 1
        job_field = {"job": self._job_id} if self._job_id else {}
        self._emit(
            "game_start",
            round=None,
            **job_field,
            num_honest=sim.game.num_honest,
            num_byzantine=sim.game.num_byzantine,
            value_range=list(sim.game.value_range),
            consensus_threshold=self._threshold,
            max_rounds=sim.game.max_rounds,
            topology=cfg.network.topology_type,
            seed=cfg.game.seed,
            backend=cfg.engine.backend,
            model=cfg.engine.model_name,
            strategy=cfg.game.byzantine_strategy,
            awareness=cfg.game.byzantine_awareness,
        )
        self._publish()

    def resync(self, sim) -> None:
        """Re-anchor on a REPLACED game object (checkpoint resume swaps
        ``sim.game`` after construction, with its own Byzantine
        assignment): refresh the role partition, threshold, and the
        previous-round influence reference — without emitting a second
        ``game_start`` or double-counting the game."""
        game = sim.game
        self._threshold = float(game.consensus_threshold)
        self._honest_ids = tuple(
            aid for aid, st in game.agents.items() if not st.is_byzantine
        )
        self._byz_ids = tuple(
            aid for aid, st in game.agents.items() if st.is_byzantine
        )
        if game.rounds:
            last = game.rounds[-1]
            self._prev_values = dict(last.agent_values)
            self._prev_byz_proposals = [
                int(last.agent_values[aid])
                for aid in self._byz_ids
                if last.agent_values.get(aid) is not None
            ]
        else:
            self._prev_values = {
                aid: st.current_value for aid, st in game.agents.items()
            }
            self._prev_byz_proposals = []

    # ------------------------------------------------------------ emission

    def _emit(self, event: str, **fields: Any) -> None:
        if self._sink is not None:
            self._sink.emit(event, game=self._game_id, **fields)

    def round_start(self, round_num: int) -> None:
        self._round_t0 = time.perf_counter()
        self._emit("round_start", round=round_num)

    def decision(self, round_num: int, agent_id: str, is_byzantine: bool,
                 value: Optional[int], outcome: str) -> None:
        """One agent's decide-phase result; ``outcome`` is ``valid`` /
        ``fallback`` (sequential-retry success) / ``invalid`` (all
        attempts failed -> abstain)."""
        obs_counters.inc("game.decisions")
        if outcome == "invalid":
            obs_counters.inc("game.decisions.invalid")
        elif outcome == "fallback":
            obs_counters.inc("game.decisions.fallback")
        self._emit(
            "decision", round=round_num, agent=agent_id,
            role="byzantine" if is_byzantine else "honest",
            value=value, outcome=outcome,
        )

    def deliveries(self, round_num: int, agent_id: str,
                   senders: Sequence[str],
                   values: Optional[Sequence[int]] = None) -> None:
        """The topology-masked inbox one agent actually received this
        round (one record per receiver, not per message — O(agents)
        lines per round, with the mask still fully reconstructable).
        ``values`` aligns with ``senders`` and records what THIS receiver
        saw from each — under an equivocating adversary the same sender's
        value differs across receivers, and this is the only record of
        that split (the report's equivocation tabulation reads it)."""
        obs_counters.inc("game.deliveries", len(senders))
        value_field = (
            {"values": [int(v) for v in values]} if values is not None else {}
        )
        self._emit(
            "deliveries", round=round_num, agent=agent_id,
            senders=list(senders), count=len(senders), **value_field,
        )

    def vote(self, round_num: int, agent_id: str, is_byzantine: bool,
             vote: Optional[bool]) -> None:
        label = "stop" if vote is True else (
            "continue" if vote is False else "abstain"
        )
        obs_counters.inc(f"game.votes.{label}")
        self._emit(
            "vote", round=round_num, agent=agent_id,
            role="byzantine" if is_byzantine else "honest", vote=label,
        )

    def round_end(self, round_num: int, game) -> None:
        """Emit the round summary + convergence metrics for the round
        the game just recorded (``game.rounds[-1]``), then roll the
        previous-round state forward and publish live gauges."""
        r = game.rounds[-1]
        conv = round_convergence(
            r,
            self._threshold,
            honest_ids=self._honest_ids,
            prev_values=self._prev_values,
            prev_byzantine_proposals=self._prev_byz_proposals,
        )
        duration_ms = (
            round((time.perf_counter() - self._round_t0) * 1e3, 3)
            if self._round_t0 is not None else None
        )
        if duration_ms is not None:
            self._round_hist.observe(duration_ms)
        self._influence_total += conv["byzantine_influence"]
        obs_counters.inc("game.rounds")
        if r.has_consensus:
            obs_counters.inc("game.rounds.consensus")
        if conv["byzantine_influence"]:
            obs_counters.inc(
                "game.byzantine.adoptions", conv["byzantine_influence"]
            )
        obs_counters.set_gauge(
            "game.distinct_honest_values", conv["distinct_honest_values"]
        )
        obs_counters.set_gauge("game.value_spread", conv["value_spread"])
        obs_counters.set_gauge(
            "game.margin_vs_threshold", conv["margin_vs_threshold"]
        )
        record = round_record(r, include_byzantine=bool(self._byz_ids))
        record.update(conv)
        self._emit("round_end", duration_ms=duration_ms, **record)
        # Roll forward: this round's values and byz proposals become the
        # next round's influence reference.
        self._prev_values = dict(r.agent_values)
        self._prev_byz_proposals = [
            int(r.agent_values[aid])
            for aid in self._byz_ids
            if r.agent_values.get(aid) is not None
        ]
        with _agg_lock:
            _agg["rounds"] += 1
            _agg["byzantine_adoptions"] += conv["byzantine_influence"]
        self._publish()

    def game_end(self, game) -> None:
        """Terminal record; idempotent (drivers may call run_round past
        game_over defensively)."""
        if self._ended:
            return
        self._ended = True
        obs_counters.inc("game.games.completed")
        if game.consensus_reached:
            obs_counters.inc("game.games.converged")
        job_field = {"job": self._job_id} if self._job_id else {}
        self._emit(
            "game_end",
            round=len(game.rounds),
            **job_field,
            converged=bool(game.consensus_reached),
            consensus_value=game.consensus_value,
            rounds=len(game.rounds),
            termination_reason=game.termination_reason,
            byzantine_influence=self._influence_total,
        )
        with _agg_lock:
            _agg["games_completed"] += 1
            if game.consensus_reached:
                _agg["games_converged"] += 1
        self._publish()

    @staticmethod
    def _publish() -> None:
        from bcg_tpu_torch.runtime import metrics

        metrics.publish_game_stats(summary())
