"""Telemetry export: Prometheus text exposition, request-lifecycle
JSONL sink, and an optional stdlib HTTP ``/metrics`` endpoint.

Three consumers of the same registry, one module:

* :func:`render_prometheus` — the counter/gauge registry in Prometheus
  text-exposition format (v0.0.4): dotted registry names become
  ``bcg_``-prefixed underscore names, counters carry the ``_total``
  suffix and ``# TYPE ... counter``, gauges ``# TYPE ... gauge``, and
  every metric's HELP line cites the original dotted name (the registry
  name IS the documentation key in DESIGN.md's taxonomy).  Escaping
  follows the exposition spec (backslash and newline in HELP text).
* :class:`EventSink` — an append-only JSONL stream of serve-path
  request lifecycle events (``admitted`` / ``rejected`` / ``cancelled``
  / ``dispatched`` / ``completed`` / ``failed``), each line carrying
  the request id, row count, and the latency breakdown the scheduler
  already measures.  Enabled by ``BCG_TPU_SERVE_EVENTS=<path>``; the
  scheduler calls :func:`emit_event`, which is a no-op when disabled.
* :func:`maybe_start_http_server` — a daemon-thread
  ``ThreadingHTTPServer`` serving ``GET /metrics`` with the live
  exposition, gated by ``BCG_TPU_METRICS_PORT`` (0 = off, the
  default).  Idempotent per process; a bind failure warns and stays
  off rather than taking the engine down.  This is the piece a
  deployment's Prometheus scrapes.

No jax import — loadable by flag-only consumers.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from bcg_tpu_torch.obs import counters as obs_counters, fleet as obs_fleet
from bcg_tpu_torch.runtime import envflags, resilience

_NAME_PREFIX = "bcg_"
_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_:]")

# Optional extra exposition blocks (labeled sample families the
# label-free registry can't carry, e.g. the alert plane's
# bcg_alert_firing{rule=...}).  None — the default, and the alerts-off
# state — keeps render_prometheus byte-identical to the provider-free
# form; bcg_tpu/obs/alerts.py installs its provider only while an
# engine is live.
_extra_blocks_provider = None
_provider_lock = threading.Lock()


def set_extra_blocks_provider(provider) -> None:
    """Install (or, with None, remove) a ``labels -> [(metric_name,
    [exposition lines])]`` callback merged into every rendered
    exposition."""
    global _extra_blocks_provider
    with _provider_lock:
        _extra_blocks_provider = provider


def prometheus_name(registry_name: str, counter: bool = False) -> str:
    """Dotted registry name -> Prometheus metric name
    (``serve.linger_le_1ms`` -> ``bcg_serve_linger_le_1ms``; counters
    get the conventional ``_total`` suffix)."""
    name = _NAME_PREFIX + _INVALID_CHARS.sub("_", registry_name.replace(".", "_"))
    if counter and not name.endswith("_total"):
        name += "_total"
    return name


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value) -> str:
    # Prometheus values are floats; render integers without the
    # trailing .0 noise (both parse identically).
    f = float(value)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def render_prometheus(typed: Optional[Dict[str, Dict[str, Any]]] = None,
                      labels: Optional[str] = None) -> str:
    """The registry (or an explicit ``snapshot_typed()``-shaped dict) in
    Prometheus text-exposition format, sorted by metric name.

    Histograms render as the conformant family the spec requires:
    cumulative ``<name>_bucket{le="..."}`` samples over the declared
    bounds plus the mandatory ``le="+Inf"`` bucket (== ``_count``),
    then ``<name>_sum`` and ``<name>_count``.

    ``labels`` is a pre-escaped label body (``process="3",host="a"``)
    applied to every sample; None resolves the fleet identity labels
    (:func:`bcg_tpu_torch.obs.fleet.prom_label_body`) — the empty string when
    fleet stamping is off, keeping the exposition byte-identical to the
    unstamped form."""
    if typed is None:
        typed = obs_counters.snapshot_typed()
    if labels is None:
        labels = obs_fleet.prom_label_body()
    wrap = f"{{{labels}}}" if labels else ""
    rows = [
        (prometheus_name(name, counter=True), name, "counter", value)
        for name, value in typed.get("counters", {}).items()
    ] + [
        (prometheus_name(name), name, "gauge", value)
        for name, value in typed.get("gauges", {}).items()
    ]
    # Histogram buckets merge the identity labels with their ``le``
    # label; every other sample takes the plain label set.
    le_prefix = f"{labels}," if labels else ""
    blocks = []
    for metric, original, kind, value in rows:
        blocks.append((metric, [
            f"# HELP {metric} "
            f"{_escape_help(f'bcg_tpu registry {kind} {original!r}')}",
            f"# TYPE {metric} {kind}",
            f"{metric}{wrap} {_format_value(value)}",
        ]))
    for name, hist in typed.get("histograms", {}).items():
        metric = prometheus_name(name)
        lines = [
            f"# HELP {metric} "
            f"{_escape_help(f'bcg_tpu registry histogram {name!r}')}",
            f"# TYPE {metric} histogram",
        ]
        for bound, cum in hist.get("buckets", []):
            lines.append(
                f'{metric}_bucket{{{le_prefix}le="{_format_value(bound)}"}} '
                f"{_format_value(cum)}"
            )
        lines.append(f'{metric}_bucket{{{le_prefix}le="+Inf"}} '
                     f"{_format_value(hist.get('count', 0))}")
        lines.append(f"{metric}_sum{wrap} "
                     f"{_format_value(hist.get('sum', 0.0))}")
        lines.append(f"{metric}_count{wrap} "
                     f"{_format_value(hist.get('count', 0))}")
        blocks.append((metric, lines))
    provider = _extra_blocks_provider
    if provider is not None:
        blocks.extend(provider(labels))
    out = []
    for _, lines in sorted(blocks, key=lambda b: b[0]):
        out.extend(lines)
    return "\n".join(out) + ("\n" if out else "")


# ------------------------------------------------------------ JSONL events

# Version of the JSONL record schemas BOTH sinks emit (serve lifecycle
# events and game events).  Bump on any breaking field change — offline
# aggregators (scripts/consensus_report.py) key merging decisions on it.
EVENT_SCHEMA_VERSION = 1


def run_manifest(**extra: Any) -> Dict[str, Any]:
    """The run-manifest header every JSONL sink writes as its FIRST
    record: run id, schema version, fleet identity, and the registered
    env-flag overrides in effect — so merging event files across a
    sweep (or across the ranks of one multi-process run) is mechanical
    (group by manifest run id + config, no out-of-band bookkeeping).
    ``extra`` fields (preset, game geometry) ride along verbatim.

    The run id comes from the fleet identity: ``BCG_TPU_RUN_ID`` when a
    launcher set one (all ranks — and both sinks of one process —
    share it), else a stable per-process 12-hex id.  ``metrics_port``
    surfaces the rank's ACTUAL ``/metrics`` port (the configured base
    offset by process_index) so a scraper can find every rank of a
    local cluster from the event files alone."""
    ident = obs_fleet.identity()
    manifest = {
        "schema_version": EVENT_SCHEMA_VERSION,
        "run_id": ident["run_id"],
        "pid": os.getpid(),
        "host": ident["host"],
        "process_index": ident["process_index"],
        "process_count": ident["process_count"],
        "metrics_port": current_http_port(),
        "flags": envflags.overrides(),
    }
    manifest.update(extra)
    return manifest


class EventSink:
    """Append-only JSONL event stream (one JSON object per line),
    written by a dedicated drainer thread.

    ``emit()`` only appends to a bounded in-memory queue — the scheduler
    calls it from its dispatch loop and (on failure paths) while holding
    its condition lock, so a stalled disk must never turn the telemetry
    sink into a serving-latency cliff.  The drainer opens the file
    lazily, writes in batches and flushes per batch (the file stays
    tail-able live); a full queue drops the OLDEST records and counts
    the loss in ``serve.events_dropped``; ``close()`` drains what is
    queued before returning (an atexit hook closes the process sink so
    a normal exit loses nothing)."""

    def __init__(self, path: str, max_queue: int = 65536,
                 drop_counter: str = "serve.events_dropped",
                 manifest: Optional[Dict[str, Any]] = None):
        self.path = path
        self._drop_counter = drop_counter
        self._cond = threading.Condition()
        self._queue: "deque" = deque(maxlen=max_queue)
        self._closed = False
        self._write_failed = False
        self._thread = threading.Thread(
            target=self._drain, name="bcg-event-sink", daemon=True
        )
        self._thread.start()
        if manifest is not None:
            # First record in the file: the run manifest (schema
            # version, run id, flag overrides) — sweep-level merging
            # keys on it.
            self.emit("manifest", **manifest)

    def emit(self, event: str, **fields: Any) -> None:
        record = {"ts": time.time(), "event": event}
        record.update(fields)
        with self._cond:
            if self._closed:
                return
            if self._write_failed:
                # Dead disk: the drainer can never land this record —
                # count the loss HERE and skip the queue entirely
                # (records already queued when the disk died are
                # counted by the drainer as it discards them, so every
                # lost record is accounted exactly once).
                obs_counters.inc(self._drop_counter)
                return
            if len(self._queue) == self._queue.maxlen:
                # deque(maxlen) evicts the oldest on append — count it.
                obs_counters.inc(self._drop_counter)
            self._queue.append(record)
            self._cond.notify()

    def _drain(self) -> None:
        fh = None
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                batch = list(self._queue)
                self._queue.clear()
                closed = self._closed
                self._cond.notify_all()  # close() waits for empty queue
            if batch and self._write_failed:
                # Queue residue from before the disk died (or from the
                # emit-side race window): discarded, and counted — a
                # dead disk must show up as events_dropped accounting,
                # not as a silently thinner event file.
                obs_counters.inc(self._drop_counter, len(batch))
            elif batch:
                written = 0
                try:
                    if fh is None:
                        fh = open(self.path, "a", encoding="utf-8")
                    # Chaos seam (BCG_TPU_CHAOS `diskfail@sink.write`):
                    # the injected OSError takes exactly the dead-disk
                    # path below — warn once, drop-and-count after.
                    resilience.inject("sink.write")
                    for record in batch:
                        fh.write(json.dumps(record, default=str) + "\n")
                        written += 1
                    fh.flush()
                except OSError as exc:
                    import sys

                    # One warning, then drop-and-count: retrying a dead
                    # disk per batch would just spin this thread.
                    print(
                        f"obs.export: event sink write failed "
                        f"({self.path}): {exc} — further events dropped "
                        f"(counted in {self._drop_counter})",
                        file=sys.stderr,
                    )
                    self._write_failed = True
                    # Exactly-once accounting on a MID-BATCH failure:
                    # records that never reached fh.write are lost —
                    # count them now.  Records already buffered are
                    # decided by the close below: flushed to disk =
                    # written (not dropped), close also failing = lost
                    # (counted) — never both on disk AND in the drop
                    # counter.
                    obs_counters.inc(self._drop_counter,
                                     len(batch) - written)
                    if fh is not None:
                        try:
                            fh.close()
                        except OSError:
                            obs_counters.inc(self._drop_counter, written)
                        fh = None
            if closed:
                break
        if fh is not None:
            fh.close()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=10.0)


_sink_lock = threading.Lock()
_sink: Optional[EventSink] = None
_sink_configured = False


def _ensure_sink() -> Optional[EventSink]:
    global _sink, _sink_configured
    if _sink_configured:
        return _sink
    with _sink_lock:
        if not _sink_configured:
            path = envflags.get_str("BCG_TPU_SERVE_EVENTS")
            if path:
                _sink = EventSink(path, manifest=run_manifest(kind="serve"))
                # Drain the queue on normal interpreter exit — the
                # writer is a daemon thread and would otherwise die
                # with the tail of the run still in memory.
                atexit.register(reset_sink)
            _sink_configured = True
    return _sink


def emit_event(event: str, **fields: Any) -> None:
    """Queue one lifecycle event for the configured sink (no-op when
    ``BCG_TPU_SERVE_EVENTS`` is unset).  Non-blocking by construction —
    the scheduler calls this from its dispatch loop and, on failure
    paths, under its condition lock; disk latency lives entirely on the
    sink's drainer thread."""
    sink = _ensure_sink()
    if sink is not None:
        sink.emit(event, **fields)


def reset_sink() -> None:
    """Drop the cached sink + its read-once flag — TEST-ONLY."""
    global _sink, _sink_configured
    with _sink_lock:
        if _sink is not None:
            _sink.close()
        _sink = None
        _sink_configured = False


# ------------------------------------------------------------ HTTP server
_server_lock = threading.Lock()
_server = None
_server_port: Optional[int] = None


def start_http_server(port: int) -> Tuple[Any, int]:
    """Start the metrics endpoint on ``port`` (0 = ephemeral) and return
    ``(server, bound_port)``.  The server thread is a daemon; call
    ``server.shutdown()`` to stop it (tests do; production lets process
    exit reap it)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (stdlib casing)
            path = self.path.split("?")[0]
            if path in ("/healthz", "/readyz"):
                # Lazy import: alerts imports this module for its
                # EventSink, so the reverse edge stays request-time.
                from bcg_tpu_torch.obs import alerts as obs_alerts

                ok, detail = (obs_alerts.health() if path == "/healthz"
                              else obs_alerts.readiness())
                body = (json.dumps(detail, sort_keys=True) + "\n"
                        ).encode("utf-8")
                self.send_response(200 if ok else 503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if path not in ("/metrics", "/"):
                self.send_response(404)
                self.end_headers()
                return
            body = render_prometheus().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):  # silence per-scrape stderr noise
            pass

    server = ThreadingHTTPServer(("127.0.0.1", port), _Handler)
    thread = threading.Thread(
        target=server.serve_forever, name="bcg-metrics-http", daemon=True
    )
    thread.start()
    return server, server.server_address[1]


def current_http_port() -> Optional[int]:
    """The bound ``/metrics`` port, or None while the endpoint is off —
    the run-manifest field (surfaced so every rank of a local cluster
    is discoverable from its event files)."""
    return _server_port


def maybe_start_http_server() -> Optional[int]:
    """Start the endpoint once per process when ``BCG_TPU_METRICS_PORT``
    is set (> 0); returns the bound port, or None when disabled.  Called
    from engine/scheduler boot — cheap no-op on every later call.

    The configured port is a BASE: each rank binds base +
    process_index, so every rank of a local multi-process cluster is
    scrapeable instead of rank 0 binding and the rest warn-and-skipping
    on the collision (single-process: process_index 0, port unchanged).
    """
    global _server, _server_port
    if _server is not None:
        return _server_port
    port = envflags.get_int("BCG_TPU_METRICS_PORT")
    if port <= 0:
        return None
    port += obs_fleet.process_index()
    with _server_lock:
        if _server is None:
            try:
                _server, _server_port = start_http_server(port)
            except OSError as exc:
                import sys

                print(
                    f"obs.export: metrics endpoint failed to bind port "
                    f"{port}: {exc} — telemetry HTTP disabled",
                    file=sys.stderr,
                )
                return None
    return _server_port


def stop_http_server() -> None:
    """Shut the process endpoint down (TEST-ONLY; production relies on
    daemon-thread teardown at exit)."""
    global _server, _server_port
    with _server_lock:
        if _server is not None:
            _server.shutdown()
            _server.server_close()
            _server = None
            _server_port = None
