"""Sweep controller: one job list, one shared serving scheduler,
games-as-tenants, checkpoint/resume at job AND round granularity,
multi-host partitioning.

The execution model (DESIGN.md "Sweep service"):

* The spec expands to a deterministic job list (:mod:`bcg_tpu_torch.sweep.
  spec`); in a multi-process JAX group rank ``r`` of ``w`` runs the
  strided partition ``jobs[r::w]`` — no coordinator, the partition is a
  pure function of the spec.  (A SINGLE-job sweep on a multi-process
  group instead runs cooperatively: every rank plays the same game and
  the SPMD exchange path rides the dp-across-hosts mesh built by
  :mod:`bcg_tpu_torch.parallel.distributed` — the one-big-game arm.)
* Jobs sharing an engine configuration share ONE engine and ONE
  :class:`~bcg_tpu_torch.serve.Scheduler`; each job is a scheduler TENANT
  (its own :class:`~bcg_tpu_torch.serve.ServingEngine` proxy tagging every
  call), so per-tenant row quotas, priority classes, and weighted-fair
  batch selection keep a 64-agent game from starving the 8-agent
  fleet.  Quota pressure surfaces as :class:`~bcg_tpu_torch.serve.
  AdmissionDeferred` with an SLO-headroom-derived retry-after, which
  the proxy absorbs as backoff latency.
* Progress is a per-rank JSONL sweep manifest (first record =
  :func:`bcg_tpu_torch.obs.export.run_manifest`, so it carries the fleet
  identity exactly like the serve/game event sinks): ``job_start`` /
  ``job_end`` records.  Resume re-expands the spec, subtracts every
  job with a completed ``job_end`` in ANY rank's manifest — or a
  ``game_end`` event on disk (the crash window between a game
  finishing and its manifest line landing can therefore never run a
  job twice) — and picks incomplete jobs back up from their newest
  round checkpoint (``BCG_TPU_SERVE_CHECKPOINT_EVERY`` machinery), so
  a killed sweep loses at most the rounds since the last checkpoint.
* Game telemetry lands in per-rank-per-attempt event files
  (``events-r<rank>-a<n>.jsonl``) that ``scripts/consensus_report.py``
  merges mechanically; :func:`render_report` is the sweep's own
  config-grouped outcome table from the manifests.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import random as _random
import statistics
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.obs import export as obs_export
from bcg_tpu_torch.obs import fleet as obs_fleet
from bcg_tpu_torch.obs import game_events as obs_game_events
from bcg_tpu_torch.runtime import envflags, resilience
from bcg_tpu_torch.sweep.spec import JobSpec, expand, load_spec, spec_name


def _manifest_path(out_dir: str, rank: int) -> str:
    return os.path.join(out_dir, f"sweep-manifest-r{rank}.jsonl")


def _iter_jsonl(pattern: str):
    """Records from every file matching ``pattern``, tolerant of a
    killed writer: blank lines, torn tails (JSONDecodeError), and files
    vanishing mid-scan (OSError) are skipped, never fatal — resume must
    read whatever a SIGKILL left behind."""
    for path in sorted(glob.glob(pattern)):
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue


def _read_manifests(out_dir: str) -> List[Dict[str, Any]]:
    """Every record from every rank's sweep manifest (resume + report
    read ALL ranks — job completion is a sweep-wide fact)."""
    return list(_iter_jsonl(os.path.join(out_dir, "sweep-manifest-r*.jsonl")))


def completed_job_ids(out_dir: str) -> Dict[str, Dict[str, Any]]:
    """job_id -> its completed ``job_end`` record, across all ranks."""
    done: Dict[str, Dict[str, Any]] = {}
    for rec in _read_manifests(out_dir):
        if rec.get("event") == "job_end" and rec.get("status") == "completed":
            done[rec["job"]] = rec
    return done


def game_end_jobs(out_dir: str) -> Dict[str, Dict[str, Any]]:
    """job_id -> ``game_end`` event record, scanned from every event
    file in the sweep dir.  This is the resume safety net for the
    window between a game finishing (its ``game_end`` flushed by the
    event sink) and the controller's ``job_end`` manifest line landing:
    a kill inside it must not replay the job — one duplicated
    ``game_end`` would corrupt every convergence denominator
    downstream."""
    ended: Dict[str, Dict[str, Any]] = {}
    for rec in _iter_jsonl(os.path.join(out_dir, "events-*.jsonl")):
        if rec.get("event") == "game_end" and rec.get("job"):
            ended[rec["job"]] = rec
    return ended


def _latest_checkpoint(job_dir: str) -> Optional[str]:
    paths = glob.glob(os.path.join(job_dir, "checkpoints", "*.json"))
    return max(paths, key=os.path.getmtime) if paths else None


class SweepController:
    """Runs one spec's job partition on this process.

    ``max_concurrent`` bounds games in flight per rank (worker
    threads); ``tenant_quota_rows``/``slo_ms``/``linger_ms`` configure
    the shared scheduler(s).  ``engine`` injects a pre-built inner
    engine for every job (tests); by default engines are created per
    distinct :meth:`~bcg_tpu_torch.sweep.spec.JobSpec.engine_key` on
    ``device`` (the torch device; ``None`` means CUDA) and owned (shut
    down) by the controller.

    In the cooperative single-job mode every rank plays the one game
    through its own scheduler over its own engine (whose ``dp`` batches
    and SPMD exchange are collectives over the world), so every rank must
    make the same engine calls in the same order.  One game makes them
    one at a time; what could part the ranks is a retry, a supervisor
    rebuild or a requeued job on one rank alone, so the dispatch retries,
    the hang watchdog and the job retries are off in this mode (a warning
    names any that was asked for).
    """

    def __init__(
        self,
        spec: Dict[str, Any],
        out_dir: str,
        *,
        max_concurrent: Optional[int] = None,
        tenant_quota_rows: Optional[int] = None,
        slo_ms: Optional[int] = None,
        linger_ms: Optional[int] = None,
        engine=None,
        max_job_retries: Optional[int] = None,
        device: Optional[str] = None,
    ):
        self.spec = spec
        self.name = spec_name(spec)
        self.out_dir = out_dir
        self.jobs: List[JobSpec] = expand(spec)
        if max_concurrent is None:
            max_concurrent = envflags.get_int("BCG_TPU_SWEEP_MAX_CONCURRENT")
        self.max_concurrent = max(1, max_concurrent)
        if max_job_retries is None:
            max_job_retries = envflags.get_int("BCG_TPU_SWEEP_MAX_JOB_RETRIES")
        self.max_job_retries = max(0, max_job_retries)
        if tenant_quota_rows is None:
            tenant_quota_rows = envflags.get_int(
                "BCG_TPU_SWEEP_TENANT_QUOTA_ROWS"
            )
        self.tenant_quota_rows = tenant_quota_rows or None
        self.slo_ms = slo_ms
        self.linger_ms = linger_ms
        self._injected_engine = engine
        self.device = device
        self.rank = obs_fleet.process_index()
        self.world = max(1, obs_fleet.process_count())
        # Cooperative mode: a single-job sweep on a multi-process group
        # is ONE game every rank plays in lockstep — the dp-across-hosts
        # arm (the job's spmd_exchange collective then spans hosts via
        # the global mesh).  Only rank 0 records events/manifest so the
        # merged report counts the game once.
        self.cooperative = self.world > 1 and len(self.jobs) == 1
        if self.cooperative:
            import warnings

            asked = [name for name, value in (
                ("max_job_retries", self.max_job_retries),
                ("BCG_TPU_SERVE_MAX_DISPATCH_RETRIES",
                 envflags.get_int("BCG_TPU_SERVE_MAX_DISPATCH_RETRIES")),
                ("BCG_TPU_SERVE_WATCHDOG_S",
                 envflags.get_int("BCG_TPU_SERVE_WATCHDOG_S")),
            ) if value]
            if asked:
                warnings.warn(
                    f"cooperative sweep: {', '.join(asked)} turned off — a "
                    "retry or rebuild on one rank alone would part the "
                    "ranks at the next collective", stacklevel=2)
            self.max_job_retries = 0
        self._man_lock = threading.Lock()
        self._engines_lock = threading.Lock()
        # engine_key -> (inner engine, shared Scheduler); booted under
        # a PER-KEY lock so two distinct engine configs can boot
        # concurrently (an engine boot can take minutes — serializing
        # unrelated groups behind one global lock would waste it).
        self._groups: Dict[Tuple, Tuple[Any, Any]] = {}
        self._group_locks: Dict[Tuple, threading.Lock] = {}
        self._prior_events_raw: Optional[str] = None
        self._events_flag_set = False
        self._started_at = time.time()

    # ------------------------------------------------------------ manifest

    def _append_manifest(self, record: Dict[str, Any]) -> None:
        if self.cooperative and self.rank != 0:
            return
        record = dict(record, ts=time.time(), rank=self.rank)
        with self._man_lock:
            with open(_manifest_path(self.out_dir, self.rank), "a") as f:  # lint: ignore[BCG-LOCK-BLOCK] _man_lock serializes the manifest appends
                f.write(json.dumps(record, default=str) + "\n")
                f.flush()
                os.fsync(f.fileno())  # lint: ignore[BCG-LOCK-BLOCK] the fsync lands before another append

    # ------------------------------------------------------------- engines

    def _group_for(self, job: JobSpec):
        """The (engine, scheduler) pair this job's tenant rides —
        created on first use per engine key, shared by every job with
        the same key (ONE model boot serves the whole partition)."""
        from bcg_tpu_torch.engine.interface import create_engine
        from bcg_tpu_torch.serve.scheduler import Scheduler

        key = job.engine_key()
        with self._engines_lock:
            pair = self._groups.get(key)
            if pair is not None:
                return pair
            key_lock = self._group_locks.setdefault(key, threading.Lock())
        with key_lock:  # only same-key jobs wait on this boot
            with self._engines_lock:
                pair = self._groups.get(key)
                if pair is not None:
                    return pair
            engine = (
                self._injected_engine
                if self._injected_engine is not None
                else create_engine(job.to_config().engine, device=self.device)
            )
            kwargs: Dict[str, Any] = {}
            if self.slo_ms is not None:
                kwargs["slo_ms"] = self.slo_ms
            if self.linger_ms is not None:
                kwargs["linger_ms"] = self.linger_ms
            if self.cooperative:
                kwargs.update(max_dispatch_retries=0, watchdog_s=0)
            pair = (engine, Scheduler(engine, **kwargs))
            with self._engines_lock:
                self._groups[key] = pair
            return pair

    def _close_groups(self) -> None:
        with self._engines_lock:
            groups = list(self._groups.values())
            self._groups.clear()
        for engine, scheduler in groups:
            try:
                scheduler.close()
            finally:
                if self._injected_engine is None:
                    engine.shutdown()

    # -------------------------------------------------------------- events

    def _configure_event_sink(self) -> None:
        """Route game telemetry into a fresh per-rank-per-attempt file
        under the sweep dir (respecting an operator-set
        ``BCG_TPU_GAME_EVENTS``).  Attempt numbering keeps a resumed
        process APPENDING NEW events to a new file instead of
        interleaving with a killed writer's torn tail."""
        # Save/restore needs the RAW value (None vs "") — the registry
        # accessors cannot round-trip "was unset".
        self._prior_events_raw = os.environ.get("BCG_TPU_GAME_EVENTS")  # lint: ignore[BCG-ENV-RAW]
        if self._prior_events_raw:
            return  # operator owns the sink
        if self.cooperative and self.rank != 0:
            return  # cooperative: only rank 0 records the shared game
        attempt = 1 + len(glob.glob(os.path.join(
            self.out_dir, f"events-r{self.rank}-a*.jsonl"
        )))
        path = os.path.join(
            self.out_dir, f"events-r{self.rank}-a{attempt}.jsonl"
        )
        os.environ["BCG_TPU_GAME_EVENTS"] = path
        self._events_flag_set = True
        obs_game_events.reset_sink()

    def _restore_event_sink(self) -> None:
        obs_game_events.reset_sink()  # drain + close this attempt's file
        if self._events_flag_set:
            if self._prior_events_raw is None:
                os.environ.pop("BCG_TPU_GAME_EVENTS", None)
            else:
                os.environ["BCG_TPU_GAME_EVENTS"] = self._prior_events_raw
            self._events_flag_set = False

    # ------------------------------------------------------- cooperative plan

    def _coop_plan_path(self) -> str:
        return os.path.join(self.out_dir, "coop-plan-r0.json")

    def _publish_coop_plan(self, pending: List[JobSpec]) -> None:
        """Rank 0 publishes THE pending-job decision for this
        cooperative launch; other ranks execute exactly it.  Without
        this, each rank would derive its own skip set from the shared
        manifest at its own start time — and a fast rank 0 finishing a
        short game before a slow rank 1 even reads the manifest makes
        rank 1 skip a game rank 0 expects to play in lockstep (a
        divergence that deadlocks the first cross-host collective on
        hardware)."""
        tmp = self._coop_plan_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump({
                "run_id": obs_fleet.run_id(),
                "ts": time.time(),
                "pending": [j.job_id for j in pending],
            }, f)
        os.replace(tmp, self._coop_plan_path())

    def _await_coop_plan(self, min_ts: float,
                         deadline_s: float = 120.0) -> List[str]:
        """Non-zero cooperative ranks: wait for rank 0's plan for THIS
        launch — matched by the shared run id (the fleet convention: the
        launcher exports one BCG_TPU_RUN_ID to every rank).  With no
        shared id, a plan is accepted only if it postdates BOTH this
        process's start window and ``min_ts`` — the newest ``job_end``
        visible in the manifests at this rank's start: a previous
        launch's stale plan necessarily predates the completions that
        made it stale, so it can never be adopted and diverge the
        lockstep job set."""
        my_run = obs_fleet.run_id()
        shared = envflags.is_set("BCG_TPU_RUN_ID")
        t0 = time.monotonic()
        poll_s = 0.005
        while time.monotonic() - t0 < deadline_s:
            try:
                with open(self._coop_plan_path()) as f:
                    plan = json.load(f)
                ts = plan.get("ts", 0)
                if (plan.get("run_id") == my_run if shared
                        else ts >= min_ts and ts >= self._started_at - 600):
                    return list(plan.get("pending", []))
            except (OSError, json.JSONDecodeError):
                pass
            # Backoff, not a fixed cadence (BCG-RETRY-SLEEP): fast while
            # rank 0 is typically milliseconds away, capped so a slow
            # rank-0 boot costs at most 4 polls/second of waiting.
            time.sleep(poll_s)
            poll_s = min(poll_s * 2, 0.25)
        raise RuntimeError(
            "cooperative sweep: rank 0 never published its job plan "
            f"({self._coop_plan_path()}) — cannot safely guess which "
            "jobs to play in lockstep"
        )

    # ----------------------------------------------------------------- run

    def run(self) -> Dict[str, Any]:
        os.makedirs(self.out_dir, exist_ok=True)
        self._started_at = time.time()
        if self.cooperative:
            mine = list(self.jobs)
        else:
            mine = self.jobs[self.rank::self.world]
        done = completed_job_ids(self.out_dir)
        ended = game_end_jobs(self.out_dir)
        # Recovery: a game that ENDED on disk without a manifest line is
        # completed — write the line it was killed before writing.
        for jid, rec in ended.items():
            if jid not in done and any(j.job_id == jid for j in mine):
                self._append_manifest({
                    "event": "job_end", "job": jid, "status": "completed",
                    "converged": bool(rec.get("converged")),
                    "rounds": int(rec.get("rounds", 0)),
                    "recovered": True,
                })
                done[jid] = rec
        if self.cooperative and self.rank != 0:
            latest_end_ts = max(
                (float(rec.get("ts", 0)) for rec in done.values()), default=0.0
            )
            plan = set(self._await_coop_plan(latest_end_ts))
            pending = [j for j in mine if j.job_id in plan]
        else:
            pending = [j for j in mine if j.job_id not in done]
            if self.cooperative:
                self._publish_coop_plan(pending)
        skipped = len(mine) - len(pending)
        if skipped:
            obs_counters.inc("sweep.jobs.skipped", skipped)
        self._append_manifest(dict(
            obs_export.run_manifest(
                kind="sweep", sweep=self.name, jobs=len(self.jobs),
                partition=len(mine), world=self.world,
                cooperative=self.cooperative,
            ),
            event="manifest",
        ))
        self._configure_event_sink()
        obs_counters.set_gauge("sweep.jobs.total", len(self.jobs))
        results: List[Dict[str, Any]] = []
        res_lock = threading.Lock()
        # Work items are (job, attempt): a TRANSIENT failure with retry
        # budget left (BCG_TPU_SWEEP_MAX_JOB_RETRIES) requeues the job
        # at the back of this rank's partition — it re-enters the same
        # strided work list, resumes from its newest round checkpoint,
        # and only its TERMINAL attempt lands in `results`, so the
        # summary (and every report keyed on the last job_end per job)
        # counts it exactly once.
        work: List[Tuple[JobSpec, int]] = [(j, 0) for j in pending]
        work_lock = threading.Lock()
        retry_rng = threading.local()

        def worker():
            while True:
                with work_lock:
                    if not work:
                        return
                    job, attempt = work.pop(0)
                out = self._run_job(job, attempt=attempt)
                if (out["status"] == "failed"
                        and out.get("failure") == "transient"
                        and attempt < self.max_job_retries):
                    obs_counters.inc("sweep.jobs.retried")
                    rng = getattr(retry_rng, "rng", None)
                    if rng is None:
                        rng = retry_rng.rng = _random.Random(
                            hash((job.job_id, self.rank)) & 0xFFFFFFFF
                        )
                    time.sleep(resilience.backoff_s(
                        attempt, base_s=0.05, cap_s=2.0, rng=rng
                    ))
                    with work_lock:
                        work.append((job, attempt + 1))
                    continue
                with res_lock:
                    results.append(out)

        try:
            if self.max_concurrent == 1 or len(pending) <= 1:
                worker()
            else:
                threads = [
                    threading.Thread(target=worker, name=f"bcg-sweep-{i}")
                    for i in range(min(self.max_concurrent, len(pending)))
                ]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
        finally:
            self._close_groups()
            self._restore_event_sink()
        completed = sum(1 for r in results if r["status"] == "completed")
        failed = sum(1 for r in results if r["status"] == "failed")
        summary = {
            "sweep": self.name,
            "out_dir": self.out_dir,
            "rank": self.rank,
            "world": self.world,
            "cooperative": self.cooperative,
            "jobs": len(self.jobs),
            "partition": len(mine),
            "skipped": skipped,
            "completed": completed,
            "failed": failed,
            "results": sorted(results, key=lambda r: r["job"]),
        }
        return summary

    # ------------------------------------------------------------ one job

    def _run_job(self, job: JobSpec, attempt: int = 0) -> Dict[str, Any]:
        from bcg_tpu_torch.runtime.checkpoint import resume_simulation
        from bcg_tpu_torch.runtime.orchestrator import BCGSimulation
        from bcg_tpu_torch.serve.engine import ServingEngine

        jid = job.job_id
        job_dir = os.path.join(self.out_dir, "jobs", jid)
        cfg = job.to_config()
        cfg = dataclasses.replace(
            cfg, metrics=dataclasses.replace(cfg.metrics, results_dir=job_dir)
        )
        obs_counters.inc("sweep.jobs")
        self._append_manifest({
            "event": "job_start", "job": jid, "params": dict(job.params),
            "attempt": attempt,
        })
        t0 = time.perf_counter()
        try:
            # Chaos seam (BCG_TPU_CHAOS `crash@sweep.job`): the injected
            # job crash fires BEFORE any game state exists, so a retried
            # attempt replays a clean job (no spurious half-game events).
            resilience.inject("sweep.job")
            engine, scheduler = self._group_for(job)
            scheduler.register_tenant(
                jid,
                weight=float(job.params["weight"]),
                priority=int(job.params["priority"]),
                quota_rows=self.tenant_quota_rows,
            )
            proxy = ServingEngine(engine, scheduler=scheduler, tenant=jid)
            ckpt = _latest_checkpoint(job_dir)
            if ckpt is not None:
                sim = resume_simulation(
                    ckpt, config=cfg, engine=proxy, sweep_job_id=jid
                )
                obs_counters.inc("sweep.jobs.resumed")
                resumed_round = sim.game.current_round
            else:
                sim = BCGSimulation(config=cfg, engine=proxy,
                                    sweep_job_id=jid)
                resumed_round = None
            try:
                if sim.game.game_over and sim._recorder is not None:
                    # Resumed a checkpoint written AFTER the final
                    # round: nothing to run, but the terminal event may
                    # have been lost with the killed writer — re-emit
                    # it (idempotent per recorder instance).
                    sim._recorder.game_end(sim.game)
                # Drive rounds directly (the api.run_simulation idiom)
                # instead of sim.run(): a 100-game sweep must not dump
                # 100 per-game results blocks to the console — the
                # manifest and event stream ARE the output.
                while not sim.game.game_over:
                    sim.run_round()
                stats = sim.game.get_statistics()
            finally:
                sim.close()
            perf = sim.profiler.summary()
            record = {
                "event": "job_end", "job": jid, "status": "completed",
                "converged": bool(stats.get("consensus_reached")),
                "rounds": int(stats.get("total_rounds", 0)),
                "rounds_per_sec": round(perf.get("rounds_per_sec", 0.0), 4),
                "decisions_per_sec": round(
                    perf.get("decisions_per_sec", 0.0), 4
                ),
                "wall_s": round(time.perf_counter() - t0, 3),
                # Engine-layer extras, persisted IN the manifest so
                # wrappers (scripts/scale_sweep.py) can rebuild their
                # legacy row from a resumed dir without re-running.
                "engine": {
                    k: getattr(engine, k)
                    for k in ("dp_batches", "dp_bypasses", "sp_bypasses")
                    if hasattr(engine, k)
                } or None,
                "spmd_mesh_dp": (
                    sim._spmd_mesh.shape.get("dp")
                    if getattr(sim, "_spmd_mesh", None) is not None else None
                ),
            }
            if resumed_round is not None:
                record["resumed_from_round"] = resumed_round
            if attempt:
                record["attempt"] = attempt
            self._append_manifest(record)
            obs_counters.inc("sweep.jobs.completed")
            result = dict(record, params=dict(job.params))
            result.pop("event")
            return result
        except Exception as e:  # one job's failure must not kill the sweep
            # (KeyboardInterrupt/SystemExit propagate: an interrupted
            # job is NOT a failed job, and Ctrl-C must stop the sweep,
            # not burn one job per press.)
            # transient vs permanent drives the requeue policy in run()
            # AND lands in the manifest: a sweep report can then
            # separate lost-work-from-flakes (retryable) from genuinely
            # broken configs (never retried).
            failure = resilience.classify_failure(e)
            self._append_manifest({
                "event": "job_end", "job": jid, "status": "failed",
                "failure": failure, "attempt": attempt,
                "error": f"{type(e).__name__}: {e}",
            })
            obs_counters.inc("sweep.jobs.failed")
            return {
                "job": jid, "status": "failed", "failure": failure,
                "error": f"{type(e).__name__}: {e}",
                "params": dict(job.params),
            }


def run_sweep(
    source,
    out_dir: str,
    *,
    max_concurrent: Optional[int] = None,
    tenant_quota_rows: Optional[int] = None,
    slo_ms: Optional[int] = None,
    linger_ms: Optional[int] = None,
    engine=None,
    max_job_retries: Optional[int] = None,
    device: Optional[str] = None,
) -> Dict[str, Any]:
    """Programmatic entry: run ``source`` (preset name, spec-file path,
    or spec mapping) into ``out_dir``; returns this rank's summary.
    Always resume-safe: jobs already completed in the dir are skipped,
    so re-invoking after a kill finishes exactly the remaining set.
    ``device``: the torch device of the engines the sweep creates."""
    spec = source if isinstance(source, dict) else load_spec(source)
    controller = SweepController(
        spec, out_dir, max_concurrent=max_concurrent,
        tenant_quota_rows=tenant_quota_rows, slo_ms=slo_ms,
        linger_ms=linger_ms, engine=engine,
        max_job_retries=max_job_retries, device=device,
    )
    return controller.run()


# ------------------------------------------------------------------ report
def _config_label(params: Dict[str, Any]) -> str:
    """Seed-free group label (seeds are replicates of one config)."""
    agents = params.get("agents", "?")
    byz = params.get("byzantine", "?")
    parts = [f"{agents}a/{byz}b", str(params.get("topology", "?"))]
    for key in ("fake_policy", "model", "awareness"):
        v = params.get(key)
        if v and v != "may_exist":
            parts.append(str(v))
    return " ".join(parts)


def render_report(out_dir: str) -> str:
    """The sweep's config-grouped outcome table from every rank's
    manifest: jobs/completed/converged per config, rounds-to-consensus
    median/mean — the single aggregated view ``python -m bcg_tpu_torch.sweep
    run`` prints.  (``scripts/consensus_report.py`` over the sweep
    dir's ``events-*.jsonl`` gives the per-round deep dive — influence,
    deliveries, fallback rates.)"""
    records = _read_manifests(out_dir)
    params_by_job: Dict[str, Dict[str, Any]] = {}
    ends: Dict[str, Dict[str, Any]] = {}
    ranks = set()
    for rec in records:
        if rec.get("event") == "manifest":
            ranks.add(rec.get("process_index"))
        elif rec.get("event") == "job_start":
            params_by_job[rec["job"]] = rec.get("params", {})
        elif rec.get("event") == "job_end":
            # Last record wins (a failed attempt superseded by a
            # resumed completion reports completed).
            prior = ends.get(rec["job"])
            if prior is None or rec.get("status") == "completed":
                ends[rec["job"]] = rec
    groups: Dict[str, List[Dict[str, Any]]] = {}
    for jid, rec in ends.items():
        label = _config_label(params_by_job.get(jid, {}))
        groups.setdefault(label, []).append(rec)
    lines = [
        f"== sweep report: {out_dir} "
        f"({len(ends)} jobs ended, {len(ranks) or 1} rank(s)) ==",
        f"{'jobs':>5}  {'done':>4}  {'conv':>4}  {'rate':>6}  "
        f"{'rounds(med/mean)':>16}  config",
    ]
    for label in sorted(groups):
        recs = groups[label]
        done = [r for r in recs if r.get("status") == "completed"]
        conv = [r for r in done if r.get("converged")]
        rounds = sorted(int(r.get("rounds", 0)) for r in conv)
        rate = 100.0 * len(conv) / len(done) if done else 0.0
        mean = sum(rounds) / len(rounds) if rounds else 0.0
        med = statistics.median(rounds) if rounds else 0.0
        lines.append(
            f"{len(recs):>5}  {len(done):>4}  {len(conv):>4}  "
            f"{rate:>5.1f}%  {med:>7.1f}/{mean:<8.1f}  {label}"
        )
    failed = [r for r in ends.values() if r.get("status") == "failed"]
    if failed:
        lines.append(f"({len(failed)} job(s) failed — see the manifest)")
    event_files = sorted(glob.glob(os.path.join(out_dir, "events-*.jsonl")))
    if event_files:
        lines.append(
            "per-round detail: python scripts/consensus_report.py "
            + " ".join(os.path.basename(p) for p in event_files)
        )
    return "\n".join(lines)
