"""Cross-simulation batching: merge concurrent games into one device batch.

TPU decode is weight-bandwidth-bound — every decode step streams the whole
model from HBM regardless of batch size — so G games of 10 agents decoded
as one 10G-row batch cost roughly what ONE game costs.  The reference
cannot do this (its vLLM engine is a process-wide singleton fed by one
synchronous loop; experiment sweeps in its README are sequential CLI
invocations).  Here, experiment throughput scales with whatever batch the
chip's memory fits.

:class:`CollectiveEngine` is an :class:`InferenceEngine` proxy shared by G
simulation threads.  Each thread's ``batch_generate_json`` blocks until
every ACTIVE participant is blocked on a call (games run in lockstep
phases, so they arrive nearly together); the proxy then merges every
guided call — temperature and token budget ride PER ROW, so a game
mid-decide batches with a game mid-vote — into one inner-engine call and
scatters the results.  Free-text calls group by top_p.  Dispatching all
pending groups whenever every active thread is blocked guarantees
progress even when retries desynchronize the phase structure.

Participants MUST call :meth:`retire` when their game ends (or crashes) —
a missing retire would leave the barrier waiting for a thread that will
never call again.  ``run_concurrent_simulations`` below handles that
bookkeeping (retire in the outermost finally), and the env-flagged
watchdog (``BCG_TPU_COLLECTIVE_WATCHDOG_S`` + :meth:`watch`) force-
retires a participant whose worker thread died without retiring, so the
barrier can no longer hang forever on a crashed thread.

For arrival-driven scheduling WITHOUT barrier semantics (no lockstep, no
retire bookkeeping, per-request crash isolation) see
:mod:`bcg_tpu_torch.serve` — this proxy remains the lockstep fallback.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from bcg_tpu_torch.engine.interface import InferenceEngine, per_row_settings as _rows
from bcg_tpu_torch.obs import tracer as obs_tracer
from bcg_tpu_torch.runtime import envflags


class _Call:
    __slots__ = ("sig", "payload", "n_rows", "temps", "budgets",
                 "results", "error")

    def __init__(self, sig: Tuple, payload, n_rows: int,
                 temps: List[float], budgets: List[int]):
        self.sig = sig
        self.payload = payload
        self.n_rows = n_rows
        self.temps = temps        # per-row, len == n_rows
        self.budgets = budgets    # per-row, len == n_rows
        self.results: Optional[List] = None
        self.error: Optional[BaseException] = None




class CollectiveEngine(InferenceEngine):
    """Thread-barrier batching proxy over a real engine.

    ``participants`` is the number of concurrently running simulations
    sharing this proxy; it decreases via :meth:`retire`.
    """

    def __init__(self, engine: InferenceEngine, participants: int,
                 watchdog_s: Optional[int] = None):
        if participants < 1:
            raise ValueError("participants must be >= 1")
        self._engine = engine
        self._cond = threading.Condition()
        self._active = participants
        self._blocked = 0
        self._pending: List[_Call] = []
        # Watchdog (BCG_TPU_COLLECTIVE_WATCHDOG_S, 0 = off): waiting
        # callers periodically reap watched threads that died WITHOUT
        # retiring — a crashed worker can then delay the barrier by at
        # most one watchdog period instead of hanging it forever.
        self._watchdog_s = (
            envflags.get_int("BCG_TPU_COLLECTIVE_WATCHDOG_S")
            if watchdog_s is None else watchdog_s
        )
        self._watched: Dict[threading.Thread, bool] = {}  # thread -> retired

    # ------------------------------------------------------------- barrier

    def watch(self, thread: threading.Thread) -> None:
        """Register a participant's worker thread for the watchdog: if it
        dies without :meth:`retire`, a waiting caller force-retires it."""
        with self._cond:
            self._watched.setdefault(thread, False)

    def _reap_dead_locked(self) -> None:
        """Force-retire watched threads that died without retiring."""
        if self._watchdog_s <= 0:
            return
        reaped = False
        for thread, retired in self._watched.items():
            if not retired and not thread.is_alive():
                self._watched[thread] = True
                self._active -= 1
                reaped = True
        if reaped and self._active > 0 and self._blocked == self._active \
                and self._pending:
            self._dispatch_all_locked()  # lint: ignore[BCG-LOCK-BLOCK] the barrier dispatches under _cond by design (waiters are parked in cond.wait)

    def _submit(self, sig: Tuple, payload, n_rows: int,
                temps: List[float], budgets: List[int]) -> List:
        call = _Call(sig, payload, n_rows, temps, budgets)
        wait_s = 60.0
        if self._watchdog_s > 0:
            wait_s = min(wait_s, max(0.05, self._watchdog_s / 4.0))
        # Traced as barrier wait: for all but the last-arriving caller
        # this span IS the time spent blocked on slower participants
        # (the last arrival's span additionally covers the merged
        # dispatch it performs — engine spans nest under it).
        with obs_tracer.span("collective.barrier_wait",
                             args={"rows": n_rows}), self._cond:
            self._pending.append(call)
            self._blocked += 1
            if self._blocked == self._active:
                self._dispatch_all_locked()  # lint: ignore[BCG-LOCK-BLOCK] the barrier dispatches under _cond by design (waiters are parked in cond.wait)
            while call.results is None and call.error is None:
                # The timeout is a lost-wakeup safety net (and, with the
                # watchdog on, the reap cadence) — not a timer.
                self._cond.wait(timeout=wait_s)
                if call.results is not None or call.error is not None:
                    break
                self._reap_dead_locked()  # lint: ignore[BCG-LOCK-BLOCK] reaping may dispatch the survivors, under the _cond that guards the watch set
                if (call.results is None and call.error is None
                        and self._blocked == self._active and self._pending):
                    self._dispatch_all_locked()  # lint: ignore[BCG-LOCK-BLOCK] the barrier dispatches under _cond by design (waiters are parked in cond.wait)
        if call.error is not None:
            raise call.error
        return call.results

    def _dispatch_all_locked(self) -> None:
        """Run every pending signature group as one merged inner call.

        Called with the lock held; the inner engine runs WITH the lock so
        exactly one device batch is in flight (the other threads are all
        blocked waiting anyway — that is the dispatch precondition).

        ``_blocked`` is decremented HERE, per satisfied call, not by the
        woken threads: a satisfied thread that hasn't been scheduled yet
        must not count toward the barrier, or the next phase's first
        arrival would see blocked == active and dispatch a lonely
        unmerged batch."""
        while self._pending:
            sig = self._pending[0].sig
            group = [c for c in self._pending if c.sig == sig]
            self._pending = [c for c in self._pending if c.sig != sig]
            merged: List = []
            temps: List[float] = []
            budgets: List[int] = []
            for c in group:
                merged.extend(c.payload)
                temps.extend(c.temps)
                budgets.extend(c.budgets)
            # Collapse to scalars when uniform so plain engines (fake,
            # stubs) that expect scalar settings keep working; the JAX
            # engine accepts per-row lists (its decode loop takes
            # temperature and budget as per-row dynamic inputs).
            temperature = temps[0] if len(set(temps)) == 1 else temps
            max_tokens = budgets[0] if len(set(budgets)) == 1 else budgets
            try:
                if sig[0] == "json":
                    out = self._engine.batch_generate_json(  # lint: ignore[BCG-LOCK-BLOCK, BCG-LOCK-CALL] the barrier's one merged dispatch, every other caller parked
                        merged, temperature=temperature, max_tokens=max_tokens
                    )
                else:
                    out = self._engine.batch_generate(  # lint: ignore[BCG-LOCK-BLOCK, BCG-LOCK-CALL] free-text arm of the same dispatch
                        merged, temperature=temperature, max_tokens=max_tokens,
                        top_p=sig[1],
                    )
                pos = 0
                for c in group:
                    c.results = out[pos: pos + c.n_rows]
                    pos += c.n_rows
            except BaseException as e:  # propagate to every caller in the group
                for c in group:
                    c.error = e
            self._blocked -= len(group)
        self._cond.notify_all()

    def retire(self) -> None:
        """A participant's game is over; shrink the barrier.

        Idempotent per WATCHED thread: a worker whose thread the
        watchdog already force-retired (it died mid-``finally``, or a
        caller raced the reap) must not shrink the barrier twice."""
        with self._cond:
            me = threading.current_thread()
            if me in self._watched:
                if self._watched[me]:
                    return  # watchdog already retired this participant
                self._watched[me] = True
            self._active -= 1
            if self._active > 0 and self._blocked == self._active and self._pending:
                self._dispatch_all_locked()  # lint: ignore[BCG-LOCK-BLOCK] the barrier dispatches under _cond by design (waiters are parked in cond.wait)
            self._cond.notify_all()

    # --------------------------------------------------- InferenceEngine API

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        if not prompts:
            return []
        n = len(prompts)
        # One signature for ALL guided calls: temperature and budget ride
        # per-row, so a game mid-decide merges with a game mid-vote.
        return self._submit(
            ("json",), list(prompts), n,
            _rows(temperature, n, float), _rows(max_tokens, n, int),
        )

    def generate_json(self, prompt, schema, temperature=0.0, max_tokens=512,
                      system_prompt=None) -> Dict[str, Any]:
        return self.batch_generate_json(
            [(system_prompt or "", prompt, schema)], temperature, max_tokens
        )[0]

    def batch_generate(self, prompts, temperature=0.0, max_tokens=256, top_p=1.0):
        if not prompts:
            return []
        n = len(prompts)
        return self._submit(
            ("free", float(top_p)), list(prompts), n,
            _rows(temperature, n, float), _rows(max_tokens, n, int),
        )

    def generate(self, prompt, temperature=0.0, max_tokens=256, top_p=1.0,
                 system_prompt=None) -> str:
        if system_prompt is not None:
            # Chat formatting is model-specific and lives in the inner
            # engine — delegate directly (unmerged; generate() is not on
            # the game's hot path) rather than silently dropping it.
            return self._engine.generate(
                prompt, temperature, max_tokens, top_p, system_prompt=system_prompt
            )
        return self.batch_generate([prompt], temperature, max_tokens, top_p)[0]

    def shutdown(self) -> None:
        # The inner engine is owned by the caller (shared across waves).
        pass


def run_concurrent_simulations(
    engine: InferenceEngine,
    run_fns: List[Callable[[InferenceEngine], Any]],
    concurrency: int,
) -> List[Any]:
    """Run ``run_fns`` (each ``fn(engine) -> result``) in lockstep waves of
    ``concurrency`` threads sharing one :class:`CollectiveEngine` per wave.

    Wave size bounds device memory: the merged batch is at most
    ``concurrency x agents`` rows of KV cache.  Results keep input order;
    a failed run stores its exception object in its slot.
    """
    results: List[Any] = [None] * len(run_fns)
    for start in range(0, len(run_fns), concurrency):
        wave = list(range(start, min(start + concurrency, len(run_fns))))
        collective = CollectiveEngine(engine, participants=len(wave))

        def worker(idx: int) -> None:
            # retire() in the OUTERMOST finally: whatever the run does —
            # raise, SystemExit, a failing result assignment — the
            # barrier bookkeeping still happens before the thread dies.
            try:
                try:
                    results[idx] = run_fns[idx](collective)
                except BaseException as e:
                    results[idx] = e
            finally:
                collective.retire()

        threads = [
            threading.Thread(target=worker, args=(i,), name=f"bcg-sim-{i}")
            for i in wave
        ]
        # Watched BEFORE start: the watchdog (env-flagged) can then
        # force-retire any worker whose thread dies without retiring.
        for t in threads:
            collective.watch(t)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    return results
