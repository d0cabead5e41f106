"""Fleet observability plane: process identity, metric shards,
heartbeats, and straggler detection.

Every other instrument in :mod:`bcg_tpu_torch.obs` is process-local: counter
snapshots, the Prometheus endpoint, the tracer ring, and both JSONL
sinks describe ONE process and carry no identity beyond a pid.  A
2-host run therefore yields two disjoint telemetry islands — and a
silent hang when one rank stalls.  This module makes every existing
signal host-aware and mergeable:

* **Identity** — one process-wide :func:`identity`: ``run_id`` (shared
  across ranks via ``BCG_TPU_RUN_ID``, else a per-process 12-hex id),
  ``process_index``/``process_count`` (from
  :mod:`bcg_tpu_torch.parallel.distributed` once the JAX process group is
  initialized — :func:`set_process_provider` — else ``0``/``1``),
  hostname, and pid.  Stamped into the run manifest of BOTH JSONL
  sinks, the tracer export, and — when :func:`enabled` — the
  Prometheus exposition as ``process=``/``host=`` labels so multi-rank
  scrapes don't collide into one anonymous metric family.
* **Metric shards** — ``BCG_TPU_METRICS_SHARD_DIR=<dir>``: a periodic
  flusher thread (:class:`ShardWriter`) appends this process's typed
  counter/gauge/histogram snapshot as one JSONL record per flush to
  ``shard-<run_id>-<process_index>.jsonl``.  Counters merge by SUM,
  histograms bucket-wise (fixed bounds make two histograms addable),
  gauges keep per-rank values — ``scripts/fleet_report.py`` (bcg_tpu-
  import-free) does the merge offline.
* **Liveness** — each flush sets the ``fleet.heartbeat_ms`` gauge
  (epoch ms of the last flush) and re-publishes the ``fleet.watermark``
  progress gauge the orchestrator (per round) and serve scheduler (per
  dispatch) advance through :func:`note_round`/:func:`note_dispatch`.
* **Straggler detection** — :func:`check_stragglers` reads the peer
  shards' newest records and flags ranks whose watermark or heartbeat
  lags the fleet median by ``BCG_TPU_FLEET_STRAGGLER_FACTOR`` (0 =
  off), publishing the count as the ``fleet.stragglers`` gauge.  The
  same rule, by value, lives in ``scripts/fleet_report.py --watch``.
  :func:`freeze_watermark` is the documented chaos hook the perf-gate
  "fleet" scenario uses to inject a straggler rank — detection is
  gated against it, never vacuously green.

Stamping is OFF in a default single-process run (no flags, no process
group): no ``fleet.*`` registry entries are created and the Prometheus
exposition stays byte-identical to the unstamped form — the acceptance
contract ``tests/test_fleet.py`` pins.

No jax import — loadable by flag-only consumers (bench.py error path);
the process provider closure (set by ``parallel/distributed.py``) is
the only thing that ever touches the backend, and only after
``jax.distributed.initialize`` succeeded.
"""

from __future__ import annotations

import atexit
import json
import os
import socket
import statistics
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.runtime import envflags

# Schema of one shard record (bump on breaking field changes —
# scripts/fleet_report.py mirrors this by value, not import).
SHARD_SCHEMA_VERSION = 1

_state_lock = threading.Lock()
_run_id: Optional[str] = None
_process_provider: Optional[Callable[[], Tuple[int, int]]] = None
_process: Optional[Tuple[int, int]] = None
_watermark = 0
_watermark_frozen = False
_writer: Optional["ShardWriter"] = None
_writer_configured = False
_last_straggler_check = 0.0


# ------------------------------------------------------------------ identity
def set_process_provider(provider: Callable[[], Tuple[int, int]]) -> None:
    """Install the ``() -> (process_index, process_count)`` source —
    called by :func:`bcg_tpu_torch.parallel.distributed.initialize` once the
    JAX process group exists.  Lazy by design: querying the backend
    inside ``initialize()`` itself would force backend creation earlier
    than callers expect."""
    global _process_provider, _process
    with _state_lock:
        _process_provider = provider
        _process = None  # re-resolve on next read


def _resolve_process() -> Tuple[int, int]:
    global _process
    with _state_lock:
        if _process is not None:
            return _process
        provider = _process_provider
    if provider is None:
        pair = (0, 1)
    else:
        try:
            idx, count = provider()
            pair = (int(idx), int(count))
        except Exception:  # lint: ignore[BCG-EXCEPT-BROAD] degrading to one process IS the handling
            # Backend torn down mid-exit: stay single-process rather
            # than taking telemetry down with it.
            pair = (0, 1)
    with _state_lock:
        _process = pair
    return pair


def process_index() -> int:
    return _resolve_process()[0]


def process_count() -> int:
    return _resolve_process()[1]


def run_id() -> str:
    """The run id every shard/manifest of this process carries:
    ``BCG_TPU_RUN_ID`` when the launcher set one (all ranks of one run
    share it — the shard-merge key), else a stable per-process 12-hex
    id."""
    global _run_id
    configured = envflags.get_str("BCG_TPU_RUN_ID")
    if configured:
        return configured
    with _state_lock:
        if _run_id is None:
            import uuid

            _run_id = uuid.uuid4().hex[:12]
        return _run_id


def identity() -> Dict[str, Any]:
    """The process's fleet identity — what manifests, shard records,
    the tracer export, and bench's ``fleet`` block carry."""
    idx, count = _resolve_process()
    return {
        "run_id": run_id(),
        "process_index": idx,
        "process_count": count,
        "host": socket.gethostname(),
        "pid": os.getpid(),
    }


def enabled() -> bool:
    """Fleet stamping on?  True when ``BCG_TPU_FLEET=1``, a shard dir
    is configured, or this process joined a multi-process group.  The
    default single-process path is OFF: no ``fleet.*`` registry
    entries, and the Prometheus exposition is byte-identical to the
    unstamped form."""
    if envflags.get_bool("BCG_TPU_FLEET"):
        return True
    if envflags.get_str("BCG_TPU_METRICS_SHARD_DIR"):
        return True
    return process_count() > 1


def _escape_label(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def prom_label_body() -> str:
    """The identity label body for Prometheus samples
    (``process="3",host="worker-a"``), or ``""`` when stamping is off —
    the empty form keeps the exposition byte-identical to the
    unstamped renderer."""
    if not enabled():
        return ""
    ident = identity()
    return (
        f'process="{ident["process_index"]}",'
        f'host="{_escape_label(ident["host"])}"'
    )


def _publish_identity_gauges() -> None:
    idx, count = _resolve_process()
    obs_counters.set_gauge("fleet.process_index", idx)
    obs_counters.set_gauge("fleet.process_count", count)


# ------------------------------------------------------- liveness watermarks
def heartbeat() -> float:
    """Set ``fleet.heartbeat_ms`` to now (epoch ms) and return it.
    Epoch time, not monotonic, deliberately: heartbeats are compared
    ACROSS processes, where each rank's monotonic clock is meaningless
    to its peers."""
    # Chaos seam (BCG_TPU_CHAOS `freeze@fleet.heartbeat`): the injected
    # rank-freeze generalizes freeze_watermark() — the rank keeps
    # heartbeating and flushing shards, but its progress watermark
    # stops, so peers must flag it by lag (the straggler rule's prey).
    from bcg_tpu_torch.runtime import resilience

    resilience.inject("fleet.heartbeat")
    now_ms = time.time() * 1e3
    obs_counters.set_gauge("fleet.heartbeat_ms", now_ms)
    return now_ms


def note_round() -> None:
    """Advance the progress watermark by one game round (orchestrator
    ``run_round``).  No-op when stamping is off (no gauge registered)
    or the watermark is frozen (injected-straggler chaos hook)."""
    _advance_watermark()


def note_dispatch() -> None:
    """Advance the progress watermark by one serve dispatch."""
    _advance_watermark()


def _advance_watermark() -> None:
    global _watermark
    if not enabled():
        return
    with _state_lock:
        if _watermark_frozen:
            return
        _watermark += 1
        value = _watermark
    if value == 1:
        # First progress of an enabled run: land the identity gauges in
        # counter snapshots even when no shard flusher is running.
        _publish_identity_gauges()
    obs_counters.set_gauge("fleet.watermark", value)


def freeze_watermark() -> None:
    """CHAOS HOOK: stop this rank's watermark from ever advancing — the
    injected-straggler arm of the perf-gate "fleet" scenario.  The rank
    keeps heartbeating and flushing shards; peers must flag it by
    watermark lag (never vacuously green)."""
    global _watermark_frozen
    with _state_lock:
        _watermark_frozen = True


# ------------------------------------------------------------ metric shards
class ShardWriter:
    """Periodic flusher: every ``flush_ms`` it heartbeats, snapshots
    the typed registry, and appends one JSONL record to this process's
    shard file.  The writer owns its thread (the EventSink idiom — a
    stalled disk never blocks a round loop; here emission itself
    already lives off the hot path) and warns once then stops on write
    failure rather than spinning a dead disk."""

    def __init__(self, shard_dir: str, flush_ms: int):
        os.makedirs(shard_dir, exist_ok=True)
        self.flush_ms = max(50, int(flush_ms))
        ident = identity()
        self.path = os.path.join(
            shard_dir,
            f"shard-{ident['run_id']}-{ident['process_index']}.jsonl",
        )
        self._lock = threading.Lock()
        self._fh = None
        self._write_failed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="bcg-fleet-shard", daemon=True
        )
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.flush_ms / 1e3):
            self.flush()
            check_stragglers()
        self.flush()  # final flush on close()

    def flush(self) -> None:
        """Write one shard record NOW (also called for the final flush
        on close/atexit so a normal exit loses nothing)."""
        hb = heartbeat()
        _publish_identity_gauges()
        record = {
            "ts": time.time(),
            "schema_version": SHARD_SCHEMA_VERSION,
            "identity": identity(),
            "flush_ms": self.flush_ms,
            "heartbeat_ms": hb,
        }
        record.update(obs_counters.snapshot_typed())
        line = json.dumps(record, default=str) + "\n"
        with self._lock:
            if self._write_failed:
                return
            try:
                if self._fh is None:
                    self._fh = open(self.path, "a", encoding="utf-8")  # lint: ignore[BCG-LOCK-BLOCK] the lock serializes the appends
                self._fh.write(line)
                self._fh.flush()
            except OSError as exc:
                import sys

                print(
                    f"obs.fleet: shard write failed ({self.path}): {exc} "
                    "— further shard flushes dropped",
                    file=sys.stderr,
                )
                self._write_failed = True

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=10.0)
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# Guards writer configuration only (never nested inside _state_lock:
# ShardWriter construction reads identity() which takes _state_lock).
_writer_lock = threading.Lock()


def maybe_start_shard_writer() -> Optional[ShardWriter]:
    """Start the process shard flusher once when
    ``BCG_TPU_METRICS_SHARD_DIR`` is set; None when disabled.  Called
    from the same boot sites as ``maybe_start_http_server`` (engine
    boot, scheduler boot, game recorder) — cheap no-op afterwards."""
    global _writer, _writer_configured
    if _writer_configured:
        return _writer
    with _writer_lock:
        if not _writer_configured:
            shard_dir = envflags.get_str("BCG_TPU_METRICS_SHARD_DIR")
            if shard_dir:
                _writer = ShardWriter(  # lint: ignore[BCG-LOCK-BLOCK] once-per-process construction
                    shard_dir, envflags.get_int("BCG_TPU_METRICS_SHARD_MS")
                )
                atexit.register(_close_writer)
            _writer_configured = True
    return _writer


def _close_writer() -> None:
    with _writer_lock:
        writer = _writer
    if writer is not None:
        writer.close()


def flush_shards() -> None:
    """Force one shard flush now (workers call this right before exit;
    the atexit close also flushes)."""
    writer = maybe_start_shard_writer()
    if writer is not None:
        writer.flush()


def shard_path() -> Optional[str]:
    writer = maybe_start_shard_writer()
    return writer.path if writer is not None else None


# ------------------------------------------------------ straggler detection
def read_last_record(path: str) -> Optional[Dict[str, Any]]:
    """Newest JSONL record of one shard file (shards are cumulative
    snapshots, so the last line IS the rank's current state).  Reads a
    bounded tail, not the whole file — peers poll this per flush."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 262144))
            tail = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    for line in reversed(tail.strip().splitlines()):
        line = line.strip()
        if not line:
            continue
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue  # truncated mid-write: take the previous line
    return None


def peer_records(shard_dir: str, run: str) -> List[Dict[str, Any]]:
    """Newest record per rank of ``run`` in ``shard_dir`` (own rank
    included)."""
    records = []
    try:
        names = sorted(os.listdir(shard_dir))
    except OSError:
        return records
    prefix = f"shard-{run}-"
    for name in names:
        if not (name.startswith(prefix) and name.endswith(".jsonl")):
            continue
        rec = read_last_record(os.path.join(shard_dir, name))
        if rec is not None:
            records.append(rec)
    return records


def detect_stragglers(
    records: List[Dict[str, Any]],
    factor: float,
    now_ms: Optional[float] = None,
) -> List[Dict[str, Any]]:
    """Ranks lagging the fleet, from a set of newest shard records.

    Two independent lag rules, both relative to the fleet so absolute
    speed never matters:

    * **watermark** — ``rank_watermark * factor < median(watermarks)``:
      the rank made less than 1/factor of the median progress;
    * **heartbeat** — the rank's last heartbeat is more than
      ``factor * flush_ms`` behind ``now_ms`` (live check) or behind
      the freshest rank (offline replay): its flusher stopped.

    ``factor <= 0`` disables detection; fewer than 2 ranks can have no
    median to lag.  Mirrored by value in ``scripts/fleet_report.py``
    (which must stay bcg_tpu-import-free) — ``tests/test_fleet.py``
    holds the two implementations to the same verdicts.
    """
    if factor <= 0 or len(records) < 2:
        return []
    gauges = [r.get("gauges") or {} for r in records]
    watermarks = [float(g.get("fleet.watermark", 0)) for g in gauges]
    heartbeats = [
        float(r.get("heartbeat_ms") or g.get("fleet.heartbeat_ms", 0))
        for r, g in zip(records, gauges)
    ]
    med_watermark = statistics.median(watermarks)
    ref_ms = now_ms if now_ms is not None else max(heartbeats, default=0.0)
    out = []
    for rec, w, hb in zip(records, watermarks, heartbeats):
        reasons = []
        if med_watermark > 0 and w * factor < med_watermark:
            reasons.append("watermark")
        flush_ms = float(rec.get("flush_ms") or 1000.0)
        if hb > 0 and (ref_ms - hb) > factor * flush_ms:
            reasons.append("heartbeat")
        if reasons:
            ident = rec.get("identity") or {}
            out.append({
                "process_index": ident.get("process_index"),
                "host": ident.get("host"),
                "reasons": reasons,
                "watermark": w,
                "median_watermark": med_watermark,
                "heartbeat_age_ms": round(ref_ms - hb, 1) if hb else None,
            })
    return out


def check_stragglers(force: bool = False) -> List[Dict[str, Any]]:
    """Runtime straggler pass: read the peer shards and publish the
    lagging-rank count as the ``fleet.stragglers`` gauge.  Rate-limited
    to one pass per flush period (the scheduler calls this per
    dispatch; a hot serving loop must not turn it into a disk scan per
    batch) unless ``force``.  No-ops when shards or detection
    (``BCG_TPU_FLEET_STRAGGLER_FACTOR=0``) are off."""
    global _last_straggler_check
    writer = maybe_start_shard_writer()
    if writer is None:
        return []
    factor = envflags.get_int("BCG_TPU_FLEET_STRAGGLER_FACTOR")
    if factor <= 0:
        return []
    now = time.monotonic()
    with _state_lock:
        if not force and now - _last_straggler_check < writer.flush_ms / 1e3:
            return []
        _last_straggler_check = now
    records = peer_records(os.path.dirname(writer.path), run_id())
    flagged = detect_stragglers(records, factor, now_ms=time.time() * 1e3)
    obs_counters.set_gauge("fleet.stragglers", len(flagged))
    return flagged


# ------------------------------------------------------------------- summary
def summary() -> Optional[Dict[str, Any]]:
    """The bench JSON ``fleet`` block: identity, shard path, heartbeat
    age, watermark, straggler count — attached on success AND error
    paths (a hung rank's last bench line should say which rank it was).
    None when stamping is off."""
    if not enabled():
        return None
    hb = obs_counters.value("fleet.heartbeat_ms", 0)
    # Heartbeats are epoch-ms BY DESIGN (compared across processes,
    # where each rank's monotonic clock is meaningless to its peers),
    # so the age is wall-clock arithmetic on purpose.
    age_ms = time.time() * 1e3 - hb  # lint: ignore[BCG-TIME-WALL]
    return {
        "identity": identity(),
        "shard_path": shard_path(),
        "heartbeat_age_ms": round(age_ms, 1) if hb else None,
        "watermark": obs_counters.value("fleet.watermark", 0),
        "stragglers": obs_counters.value("fleet.stragglers", 0),
    }


def reset() -> None:
    """TEST-ONLY: close the shard writer and drop all cached state so
    the next use re-reads the environment."""
    global _run_id, _process_provider, _process, _watermark
    global _watermark_frozen, _writer, _writer_configured
    global _last_straggler_check
    _close_writer()
    with _writer_lock:
        _writer = None
        _writer_configured = False
    with _state_lock:
        _run_id = None
        _process_provider = None
        _process = None
        _watermark = 0
        _watermark_frozen = False
        _last_straggler_check = 0.0
