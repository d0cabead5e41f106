"""`InferenceEngine`-conforming proxy over the continuous-batching
scheduler, plus the serving counterpart of
``collective.run_concurrent_simulations``.

:class:`ServingEngine` is shared by any number of game threads: each
call enqueues as an independent request and blocks only on its OWN
future, so a slow or crashed game never stalls the others (contrast the
collective barrier, which dispatches only when every active participant
is blocked).  No ``retire()`` bookkeeping exists to forget — a finished
game simply stops submitting.
"""

from __future__ import annotations

import itertools
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from bcg_tpu_torch.engine.interface import InferenceEngine, per_row_settings as _rows
from bcg_tpu_torch.runtime import envflags
from bcg_tpu_torch.serve.scheduler import AdmissionDeferred, Scheduler, SchedulerClosed


class ServingEngine(InferenceEngine):
    """Continuous-batching proxy: the serving-stack replacement for
    :class:`~bcg_tpu_torch.engine.collective.CollectiveEngine`.

    ``owns_inner=True`` makes :meth:`shutdown` also shut the inner
    engine down (for callers that created the inner engine solely to
    wrap it); by default the inner engine stays caller-owned, matching
    the collective proxy's contract.

    ``tenant`` attributes every call to a registered scheduler tenant
    (the sweep tier hands each game its own proxy over ONE shared
    scheduler): quota deferrals (:class:`AdmissionDeferred`) are
    retried transparently after the scheduler's retry-after hint, so
    the game thread experiences backpressure as latency, never as an
    exception.
    """

    _proxy_seeds = itertools.count(1)

    def __init__(self, engine: InferenceEngine, *, owns_inner: bool = False,
                 scheduler: Optional[Scheduler] = None,
                 tenant: Optional[str] = None,
                 defer_wait_ceiling_s: Optional[float] = None,
                 **scheduler_kwargs):
        # Over an engine on a mesh of ranks, rank 0 leads: its scheduler's
        # every engine call goes to the other ranks first, which follow
        # (serve/mesh.py); shutdown() ends their loops.  A proxy over a
        # scheduler its caller built leads nothing: that caller keeps the
        # ranks in step (the cooperative sweep, where every rank plays the
        # one game through its own scheduler).
        from bcg_tpu_torch.serve import mesh as mesh_serving

        self.leader = None
        if scheduler is None and mesh_serving.spans_world(engine):
            if not mesh_serving.is_leader():
                raise ValueError(
                    "ServingEngine over a mesh engine runs on rank 0; the other ranks "
                    "follow its dispatches (bcg_tpu_torch.serve.mesh.follow)")
            engine = self.leader = mesh_serving.MeshLeader(engine)
            scheduler_kwargs["engine_factory"] = self.leader.wrap_factory(
                scheduler_kwargs.get("engine_factory"))
        self._engine = engine
        if scheduler is not None:
            # Standing in for the engine in a game that every rank plays:
            # the orchestrator's SPMD exchange runs over the engine's mesh
            # and device.
            self.mesh = getattr(engine, "mesh", None)
            self.device = getattr(engine, "device", None)
        self._owns_inner = owns_inner
        self._tenant = tenant
        if defer_wait_ceiling_s is None:
            defer_wait_ceiling_s = envflags.get_int("BCG_TPU_SERVE_DEFER_WAIT_S")
        self._defer_ceiling_s = max(0.0, float(defer_wait_ceiling_s))
        # Seeded per proxy from a process-wide counter: jitter must
        # decorrelate TENANTS, so each proxy draws its own sequence —
        # and the counter (unlike id(self), whose freed addresses
        # CPython reuses) can never hand two proxies the same seed.
        self._defer_rng = random.Random(next(ServingEngine._proxy_seeds))
        self.scheduler = scheduler or Scheduler(engine, **scheduler_kwargs)

    def _submit_with_retry(self, sig, payload, temps, budgets) -> List:
        """submit_and_wait, retrying tenant-quota deferrals after the
        carried retry-after — JITTERED (0.75x-1.25x) so deferred
        tenants spread over the dispatch window instead of herding back
        at the same instant, and CEILINGED: cumulative backoff past
        ``BCG_TPU_SERVE_DEFER_WAIT_S`` surfaces :class:`SchedulerClosed`
        (a scheduler that defers one tenant for minutes is wedged from
        that tenant's point of view, and an unbounded fixed-sleep loop
        would spin on it forever).  A dead scheduler thread surfaces
        the same way immediately."""
        waited = 0.0
        while True:
            try:
                return self.scheduler.submit_and_wait(
                    sig, payload, temps, budgets, tenant=self._tenant
                )
            except AdmissionDeferred as e:
                if not self.scheduler._thread.is_alive():
                    raise SchedulerClosed(
                        "scheduler thread died while this tenant backed "
                        "off a quota deferral"
                    ) from e
                delay = e.retry_after_s * self._defer_rng.uniform(0.75, 1.25)
                if (self._defer_ceiling_s > 0
                        and waited + delay > self._defer_ceiling_s):
                    raise SchedulerClosed(
                        f"tenant {self._tenant!r} spent "
                        f"{waited + delay:.1f}s in quota-deferral backoff "
                        f"(ceiling {self._defer_ceiling_s:g}s, "
                        "BCG_TPU_SERVE_DEFER_WAIT_S) — scheduler is not "
                        "draining this tenant's queue"
                    ) from e
                time.sleep(delay)
                waited += delay

    # --------------------------------------------------- InferenceEngine API

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        if not prompts:
            return []
        n = len(prompts)
        # One signature for ALL guided calls: temperature and budget ride
        # per-row, so a game mid-decide merges with a game mid-vote.
        return self._submit_with_retry(
            ("json",), list(prompts),
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
        return self._submit_with_retry(
            ("free", float(top_p)), list(prompts),
            _rows(temperature, n, float), _rows(max_tokens, n, int),
        )

    def generate(self, prompt, temperature=0.0, max_tokens=256, top_p=1.0,
                 system_prompt=None) -> str:
        if system_prompt is not None:
            # Chat formatting is model-specific and lives in the inner
            # engine — delegate directly (generate() is off the game's
            # hot path), serialized against in-flight device batches via
            # the scheduler's device lock.
            # Through the scheduler's CURRENT engine handle, not the
            # construction-time one — the supervisor may have rebuilt
            # the engine after a hang.
            return self.scheduler.run_exclusive(
                lambda: self.scheduler._engine.generate(
                    prompt, temperature, max_tokens, top_p,
                    system_prompt=system_prompt,
                )
            )
        return self.batch_generate([prompt], temperature, max_tokens, top_p)[0]

    def shutdown(self) -> None:
        self.scheduler.close()
        if self.leader is not None:
            self.leader.close()
        if self._owns_inner:
            # The scheduler's CURRENT engine, not the construction-time
            # handle: the supervisor may have swapped in a rebuilt
            # engine after a hang (the hung original is deliberately
            # abandoned — a shutdown() on a wedged device can hang
            # exactly like the call that condemned it).
            self.scheduler._engine.shutdown()

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        """Live scheduler counters (queue depth, batch occupancy, linger
        histogram, admission rejections)."""
        return self.scheduler.snapshot()


def run_serving_simulations(
    engine: InferenceEngine,
    run_fns: List[Callable[[InferenceEngine], Any]],
    max_concurrent: Optional[int] = None,
    serving: Optional[ServingEngine] = None,
    **scheduler_kwargs,
) -> List[Any]:
    """Run ``run_fns`` (each ``fn(engine) -> result``) concurrently against
    one shared :class:`ServingEngine`.

    Unlike ``run_concurrent_simulations`` there are no lockstep waves: all
    games run at their own pace and the scheduler merges whatever calls
    coincide within the linger window.  ``max_concurrent`` bounds the
    games running AT ONCE (the KV-memory analog of the collective wave
    size) via a semaphore — a finished game's slot is reused immediately
    instead of waiting for its whole wave to drain.

    Results keep input order; a failed run stores its exception object in
    its slot (crash isolation: the scheduler and every other game keep
    going).

    Pass a pre-built ``serving`` proxy to share/inspect its scheduler;
    it then stays OPEN after the call (caller-owned), whereas an
    internally built one is closed on return.

    Over an engine on a mesh of ranks the games play on rank 0; every
    other rank follows its dispatches (``serve/mesh.follow``) until rank 0
    closes, and returns ``None`` for each run.
    """
    from bcg_tpu_torch.serve import mesh as mesh_serving

    if serving is None and mesh_serving.spans_world(engine) and not mesh_serving.is_leader():
        mesh_serving.follow(engine, scheduler_kwargs.get("engine_factory"))
        return [None] * len(run_fns)
    caller_owned = serving is not None
    if serving is None:
        serving = ServingEngine(engine, **scheduler_kwargs)
    gate = (
        threading.BoundedSemaphore(max_concurrent)
        if max_concurrent and max_concurrent < len(run_fns) else None
    )
    results: List[Any] = [None] * len(run_fns)

    def worker(idx: int) -> None:
        if gate is not None:
            gate.acquire()
        try:
            results[idx] = run_fns[idx](serving)
        except BaseException as e:
            results[idx] = e
        finally:
            if gate is not None:
                gate.release()

    threads = [
        threading.Thread(target=worker, args=(i,), name=f"bcg-serve-{i}")
        for i in range(len(run_fns))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if not caller_owned:
        # The inner engine stays caller-owned; only the scheduler (and a
        # mesh's followers) close.
        serving.scheduler.close()
        if serving.leader is not None:
            serving.leader.close()
    return results
