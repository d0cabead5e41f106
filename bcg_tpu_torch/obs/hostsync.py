"""Runtime host↔device sync auditor (``BCG_TPU_HOSTSYNC``) — the port
of ``bcg_tpu/obs/hostsync.py``: the same auditor, counter names, round
windows and attribution ladder, at the PyTorch engine's own seams.

Mechanics — two complementary capture paths:

* **Instrumented seams.**  The known materialization points call
  :func:`note` with a site name (attributed to the loop entry the
  engine labels with :func:`jit_entry`, or explicitly): the
  ``prefill_barrier`` (``torch.cuda.synchronize`` after prefill), the
  ``decode_readback`` and ``steps_readback`` after each decode loop, the
  ``spec_readback`` of the speculative loop's drafted/accepted counts,
  and ``done_poll``, the "all rows done" read the eager loops make every
  ``_DONE_CHECK`` steps (the JAX loop runs on the device and has none).
  The seams count the same on the CPU and the card.
* **Unexpected syncs on the card.**  When the auditor is on and a CUDA
  device is present, ``torch.cuda.set_sync_debug_mode("warn")`` makes
  every synchronizing operation warn; the warnings hook counts each one
  that runs outside a seam's :func:`expected` block (site
  ``device_sync``, plus a bounded ``file:line`` table,
  :meth:`HostSyncAuditor.unexpected_table`) and swallows the warning.  A
  seam's own sync runs inside :func:`expected`, which marks the calling
  thread: the hook swallows that thread's sync warnings uncounted for the
  block, so the seam is counted once, at its :func:`note`, while syncs on
  every other thread go on being counted.  The debug mode itself is
  process-wide and stays ``warn`` while the hook is installed;
  :func:`reset` uninstalls the hook and puts back the mode it found.

Attribution, per observed sync (the remainder is COUNTED as
unattributed, never dropped):

1. the innermost open tracer span on the calling thread
   (:func:`bcg_tpu_torch.obs.tracer.current`), when tracing is on;
2. else the loop-entry name — the explicit ``entry=`` tag a seam
   passes, or the top of the thread-local :func:`jit_entry` stack —
   rendered as ``jit_<entry>``;
3. else ``unattributed``.

Surfaces (all zero when the flag is off — no counters registered, no
interception installed):

* ``engine.hostsync.total`` / ``.attributed`` / ``.unattributed``
  counters, plus ``engine.hostsync.site.<site>`` per seam and the
  attribution table ``engine.hostsync.span.<name>``;
* the ``game.host_syncs`` per-round histogram, observed by the
  orchestrator around each ``round`` span;
* ``runtime.metrics.LAST_HOSTSYNC`` (:func:`publish`).

Flags are read ONCE at first use (per-note env reads would be
measurable on the decode hot path); tests reconfigure via
:func:`reset`.  No torch import at module scope; torch is touched only
inside interception install/uninstall and the :func:`expected` blocks,
and only when the auditor is enabled on a card.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Optional

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.obs import tracer as obs_tracer
from bcg_tpu_torch.runtime import envflags

# Attribution/site fragments must stay inside the metric-name taxonomy
# ([a-z0-9_] per segment, BCG-OBS-NAME): span names like
# ``serve.request`` flatten to ``serve_request``.
_SANITIZE_RE = re.compile(r"[^a-z0-9_]")

# Per-round sync histogram bounds.  Today's lockstep round performs a
# handful of syncs per batched engine call; the mega-round target is ~1,
# so the ladder resolves both the current regime and the fused one.
ROUND_SYNC_BOUNDS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0,
                     512.0)

# What PyTorch's sync debug mode warns with (``c10/cuda``), and how many
# distinct source lines the unexpected-sync table keeps.
_SYNC_WARNING = "called a synchronizing CUDA operation"
UNEXPECTED_TABLE_CAP = 64


def _sanitize(name: str) -> str:
    return _SANITIZE_RE.sub("_", name.lower())


class _NullEntry:
    """Shared no-op context manager — the disabled-auditor fast path
    (the tracer's ``_NullSpan`` idiom)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_ENTRY = _NullEntry()


class _EntryCm:
    """Pushes one jit-entry name onto the calling thread's stack for the
    duration of the block — the tracing-off attribution source."""

    __slots__ = ("_auditor", "_name")

    def __init__(self, auditor: "HostSyncAuditor", name: str):
        self._auditor = auditor
        self._name = name

    def __enter__(self):
        self._auditor._entry_stack().append(self._name)
        return None

    def __exit__(self, exc_type, exc, tb):
        stack = self._auditor._entry_stack()
        if stack:
            stack.pop()
        return False


# Per thread: how many :func:`expected` blocks are open on it.
_seam = threading.local()


def _in_seam() -> bool:
    return getattr(_seam, "depth", 0) > 0


class _ExpectedCm:
    """A seam's own synchronization: the calling thread's sync warnings
    go uncounted for the block, so the seam's :func:`note` is its only
    count (other threads' syncs are still counted)."""

    __slots__ = ()

    def __enter__(self):
        _seam.depth = getattr(_seam, "depth", 0) + 1
        return None

    def __exit__(self, exc_type, exc, tb):
        _seam.depth -= 1
        return False


_EXPECTED = _ExpectedCm()


class _RoundWindow:
    """One open game round's audit window: the auditor total at round
    start, plus whether another round overlapped it (concurrent games —
    see :meth:`HostSyncAuditor.end_round`)."""

    __slots__ = ("start", "overlapped")

    def __init__(self, start: int):
        self.start = start
        self.overlapped = False


class HostSyncAuditor:
    """Process-wide sync recorder; one instance per enabled process
    (module surface below).  All mutation goes through the counter
    registry, so snapshots/deltas/exposition ride the established
    machinery for free."""

    def __init__(self):
        self._local = threading.local()
        self._installed_showwarning = None
        self._orig_showwarning = None
        self._warning_filter = None
        self._prev_debug_mode = None
        self._unexpected: Dict[str, int] = {}
        # install/uninstall_interception may run from several threads;
        # the check-then-act on _installed_showwarning must be atomic or
        # two installers can chain-wrap warnings.showwarning and lose
        # the true original.
        self._install_lock = threading.Lock()
        self._round_lock = threading.Lock()
        self._open_rounds: list = []
        # Register the namespace at construction: an enabled-but-idle
        # process still advertises the audit surface (and the exact-
        # bytes zero-surface test has a definite complement to pin).
        obs_counters.counter("engine.hostsync.total")
        obs_counters.counter("engine.hostsync.attributed")
        obs_counters.counter("engine.hostsync.unattributed")

    # ------------------------------------------------------------ recording

    def _entry_stack(self) -> list:
        stack = getattr(self._local, "entries", None)
        if stack is None:
            stack = self._local.entries = []
        return stack

    def jit_entry(self, name: str) -> _EntryCm:
        return _EntryCm(self, name)

    def current_entry(self) -> Optional[str]:
        stack = getattr(self._local, "entries", None)
        return stack[-1] if stack else None

    def note(self, site: str, n: int = 1, entry: Optional[str] = None) -> None:
        """Record ``n`` device→host materializations at ``site``,
        attributed span-first (innermost open tracer span), then to the
        jit-entry name (explicit ``entry=`` beats the thread-local
        stack), else counted unattributed."""
        if n <= 0:
            return
        span = obs_tracer.current()
        if span is not None:
            attr = _sanitize(span.name)
        else:
            jit = entry if entry is not None else self.current_entry()
            attr = f"jit_{_sanitize(jit)}" if jit else None
        obs_counters.inc("engine.hostsync.total", n)
        obs_counters.inc(f"engine.hostsync.site.{_sanitize(site)}", n)
        if attr is not None:
            obs_counters.inc("engine.hostsync.attributed", n)
            obs_counters.inc(f"engine.hostsync.span.{attr}", n)
        else:
            obs_counters.inc("engine.hostsync.unattributed", n)
            obs_counters.inc("engine.hostsync.span.unattributed", n)

    def total(self) -> int:
        return int(obs_counters.value("engine.hostsync.total"))

    def begin_round(self) -> _RoundWindow:
        """Open one game round's audit window.  Any other round open at
        the same time (concurrent games sharing one serving engine)
        marks BOTH windows overlapped: the process-wide total cannot
        split a shared dispatch batch's syncs between games, and an
        overcounted observation would corrupt exactly the metric the
        mega-round work drives down."""
        with self._round_lock:
            window = _RoundWindow(self.total())
            if self._open_rounds:
                window.overlapped = True
                for other in self._open_rounds:
                    other.overlapped = True
            self._open_rounds.append(window)
        return window

    def end_round(self, window: _RoundWindow, observe: bool = True) -> None:
        """Close a round window: an unoverlapped round observes its
        exact sync delta into the ``game.host_syncs`` histogram
        (created here — only an enabled auditor ever registers it);
        an overlapped one is COUNTED (``engine.hostsync.rounds_overlapped``)
        rather than observed wrong or dropped silently.

        ``observe=False`` discards the window without recording — the
        failed-round path, which must still REMOVE the window: a leaked
        entry in ``_open_rounds`` would mark every later round
        overlapped and silently stop the histogram for the rest of the
        process."""
        with self._round_lock:
            if window in self._open_rounds:
                self._open_rounds.remove(window)
            syncs = self.total() - window.start
            overlapped = window.overlapped
        if not observe:
            return
        if overlapped:
            obs_counters.inc("engine.hostsync.rounds_overlapped")
        else:
            obs_counters.histogram("game.host_syncs",
                                   ROUND_SYNC_BOUNDS).observe(syncs)
        self.publish()

    # -------------------------------------------------------- interception

    def install_interception(self) -> None:
        """On a CUDA card, count every synchronizing operation outside a
        seam (site ``device_sync``): the sync debug mode set to warn,
        and ``warnings.showwarning`` wrapped to count and swallow those
        warnings (any other warning passes through).  No card: the
        seams alone are audited."""
        try:
            import torch
        except ImportError:
            return
        if not torch.cuda.is_available():
            return
        import warnings

        with self._install_lock:
            if self._installed_showwarning is not None:
                return
            orig = warnings.showwarning

            def _audited_showwarning(message, category, filename, lineno,
                                     file=None, line=None):
                if _SYNC_WARNING in str(message):
                    if not _in_seam():
                        self._note_unexpected(filename, lineno)
                    return None
                return orig(message, category, filename, lineno, file, line)

            # "always": the default filter would show (and so count) a
            # sync at one source line only once.
            warnings.filterwarnings("always", message=f".*{_SYNC_WARNING}")
            self._warning_filter = warnings.filters[0]
            self._orig_showwarning = orig
            self._installed_showwarning = _audited_showwarning
            warnings.showwarning = _audited_showwarning
            self._prev_debug_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def uninstall_interception(self) -> None:
        with self._install_lock:
            if self._installed_showwarning is None:
                return
            import warnings

            import torch

            torch.cuda.set_sync_debug_mode(self._prev_debug_mode)
            self._prev_debug_mode = None
            # Only restore if nothing else re-wrapped it after us.
            if warnings.showwarning is self._installed_showwarning:
                warnings.showwarning = self._orig_showwarning
            if self._warning_filter in warnings.filters:
                warnings.filters.remove(self._warning_filter)
                # Invalidate the per-module "already warned" caches.
                getattr(warnings, "_filters_mutated", lambda: None)()
            self._installed_showwarning = None
            self._orig_showwarning = None
            self._warning_filter = None

    def intercepting(self) -> bool:
        return self._installed_showwarning is not None

    def _note_unexpected(self, filename: str, lineno: int) -> None:
        where = f"{filename}:{lineno}"
        with self._round_lock:
            if where in self._unexpected or len(self._unexpected) < UNEXPECTED_TABLE_CAP:
                self._unexpected[where] = self._unexpected.get(where, 0) + 1
        self.note("device_sync")

    def unexpected_table(self) -> Dict[str, int]:
        """{``file:line``: syncs} of the synchronizing operations counted
        outside a seam, most frequent first (bounded by
        :data:`UNEXPECTED_TABLE_CAP` distinct lines)."""
        with self._round_lock:
            items = sorted(self._unexpected.items(), key=lambda kv: -kv[1])
        return dict(items)

    # ------------------------------------------------------------- reading

    @staticmethod
    def _table(snap: Dict, prefix: str) -> Dict[str, int]:
        return {
            name[len(prefix):]: int(value)
            for name, value in snap.items()
            if name.startswith(prefix)
        }

    def attribution_table(self) -> Dict[str, int]:
        """{attribution name: syncs} — span names as recorded,
        jit-entry attributions under their ``jit_`` prefix, plus
        ``unattributed`` when anything escaped."""
        return self._table(obs_counters.snapshot(),
                           "engine.hostsync.span.")

    def site_table(self) -> Dict[str, int]:
        return self._table(obs_counters.snapshot(),
                           "engine.hostsync.site.")

    def summary(self) -> Dict:
        """The bench-JSON / LAST_HOSTSYNC form: totals, attribution
        coverage, per-site and per-attribution tables, and the
        per-round histogram's count/sum/mean when any round was
        observed.  ONE registry snapshot feeds everything — publish()
        runs this per generation call, so it must not rescan the
        registry per table."""
        snap = obs_counters.snapshot()
        total = int(snap.get("engine.hostsync.total", 0))
        attributed = int(snap.get("engine.hostsync.attributed", 0))
        out: Dict = {
            "total": total,
            "attributed": attributed,
            "unattributed": int(
                snap.get("engine.hostsync.unattributed", 0)
            ),
            "attribution_coverage": (
                round(attributed / total, 4) if total else None
            ),
            "by_site": self._table(snap, "engine.hostsync.site."),
            "by_span": self._table(snap, "engine.hostsync.span."),
        }
        if self._unexpected:
            out["device_sync_lines"] = self.unexpected_table()
        rounds = int(snap.get("game.host_syncs.count", 0))
        if rounds:
            syncs = snap.get("game.host_syncs.sum", 0)
            out["rounds"] = {
                "count": rounds,
                "syncs": int(syncs),
                "syncs_per_round": round(syncs / rounds, 4),
            }
        return out

    def publish(self) -> None:
        """Mirror the summary into ``runtime.metrics.LAST_HOSTSYNC`` so
        bench.py attaches it on success AND error paths (the
        LAST_SERVE_STATS idiom: a mid-wave crash keeps the profile the
        completed calls already recorded)."""
        from bcg_tpu_torch.runtime import metrics

        metrics.publish_hostsync(self.summary())


# ---------------------------------------------------------- module surface
_config_lock = threading.Lock()
_auditor: Optional[HostSyncAuditor] = None
_configured = False


def _ensure() -> Optional[HostSyncAuditor]:
    global _auditor, _configured
    if _configured:
        return _auditor
    with _config_lock:
        if not _configured:
            if envflags.get_bool("BCG_TPU_HOSTSYNC"):
                _auditor = HostSyncAuditor()
                _auditor.install_interception()
            _configured = True
    return _auditor


def auditor() -> Optional[HostSyncAuditor]:
    """The active auditor, or None when auditing is disabled."""
    return _ensure()


def enabled() -> bool:
    return _ensure() is not None


def note(site: str, n: int = 1, entry: Optional[str] = None) -> None:
    """Record ``n`` syncs at ``site`` (module-level seam API; no-op when
    disabled — call sites never need their own guard)."""
    a = _auditor if _configured else _ensure()
    if a is not None:
        a.note(site, n, entry=entry)


def jit_entry(name: str):
    """Context manager labelling the block with a jit-entry name for
    tracing-off attribution; shared no-op when disabled."""
    a = _auditor if _configured else _ensure()
    return a.jit_entry(name) if a is not None else _NULL_ENTRY


def expected():
    """Context manager around a seam's own synchronizing read: keeps it
    out of the unexpected-sync count (shared no-op unless the auditor
    intercepts on a card)."""
    a = _auditor if _configured else _ensure()
    return _EXPECTED if a is not None and a.intercepting() else _NULL_ENTRY


def total() -> int:
    a = _auditor if _configured else _ensure()
    return a.total() if a is not None else 0


def summary() -> Optional[Dict]:
    a = _auditor if _configured else _ensure()
    return a.summary() if a is not None else None


def publish() -> None:
    a = _auditor if _configured else _ensure()
    if a is not None:
        a.publish()


def reset() -> None:
    """Uninstall interception and drop the cached auditor + read-once
    flag cache so the next use re-reads the environment — TEST-ONLY.
    Registered ``engine.hostsync.*`` counters persist in the registry
    (live consumers hold baselines); tests needing a pristine registry
    use a subprocess (tests/test_hostsync.py zero-surface pin)."""
    global _auditor, _configured
    with _config_lock:
        if _auditor is not None:
            _auditor.uninstall_interception()
        _auditor = None
        _configured = False
