"""The serving tier over an engine on a mesh of ranks: rank 0 leads, every
other rank follows.

In the JAX package one controller drives every device of a mesh, so its
:class:`~bcg_tpu_torch.serve.engine.ServingEngine` needs nothing more.  In
the port each rank is a process that holds its slices of the engine, and
every engine call is a collective program: all ranks must make the same
calls, with the same merged rows, in the same order.  Schedulers of their
own would merge requests at their own moments (and a ``dp`` split of their
batches would differ), so the ranks would issue different calls and the
world would hang.  So:

* rank 0 runs the one scheduler.  Its engine is a :class:`MeshLeader`,
  which broadcasts each call — the method, the merged rows with their
  schemas, temperatures and budgets, and the dispatch index — to every
  rank before making it;
* every other rank runs :func:`follow`, which receives each dispatch and
  makes the same call on its own engine;
* the scheduler's supervisor rebuild reaches the followers as a message
  (each rebuilds its engine from its own factory; the hung call's thread
  holds the condemned proxy, which can no longer send), and a retry is
  just another dispatch;
* :meth:`MeshLeader.close` (through ``ServingEngine.shutdown`` and
  ``run_serving_simulations``) sends
  the message that ends the followers' loops.

A chaos fault injected at the scheduler's ``serve.dispatch`` seam lands
on rank 0 before the broadcast, so the followers never see the failed
attempt, only its retry.  A failure inside the engine call is the same
on every rank (the same rows, the same program); a follower records it
and waits for the leader's retry.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

from bcg_tpu_torch.parallel.collectives import broadcast_object

_CALL, _REBUILD, _END = "call", "rebuild", "end"
# The engine calls a dispatch may make (the scheduler's batch calls and
# the proxy's system-prompt ``generate``).
_METHODS = ("batch_generate_json", "batch_generate", "generate")


def _world() -> tuple:
    import torch.distributed as dist

    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def spans_world(engine) -> bool:
    """Whether ``engine`` is one rank's part of an engine on a mesh of
    more than one rank (so serving it needs a leader and followers)."""
    mesh = getattr(engine, "mesh", None)
    return mesh is not None and mesh.size() > 1 and _world()[1] > 1


def is_leader() -> bool:
    """Rank 0 of the world (or no world): the rank that runs the
    scheduler and plays the games."""
    return _world()[0] == 0


class _LeaderState:
    """What every proxy of one leader shares across engine rebuilds: the
    dispatch count, the log and whether the followers were ended."""

    def __init__(self, record: bool):
        self.lock = threading.Lock()
        self.index = 0
        self.closed = False
        self.record = record
        self.log: List[dict] = []


class EngineCondemned(RuntimeError):
    """A call on an engine the supervisor replaced (a hung call's thread
    waking up): it must not reach the followers, which serve the new one."""


class MeshLeader:
    """Rank 0's engine proxy: each call is broadcast to the followers,
    then made on the inner engine.  Every other attribute is the inner
    engine's (``cap_for``, ``max_model_len``, the counters), so the
    scheduler's row cap is the mesh engine's own.  ``record``: keep each
    dispatch's message and output in :attr:`log` (the card check replays
    them through a one-rank engine)."""

    def __init__(self, engine, record: bool = False, state: Optional[_LeaderState] = None):
        self._engine = engine
        self._state = state or _LeaderState(record)
        self._condemned = False

    def __getattr__(self, name: str) -> Any:
        return getattr(self._engine, name)

    @property
    def record(self) -> bool:
        return self._state.record

    @record.setter
    def record(self, on: bool) -> None:
        self._state.record = on

    @property
    def log(self) -> List[dict]:
        return self._state.log

    def _call(self, method: str, *args, **kwargs):
        st = self._state
        with st.lock:
            if self._condemned:
                raise EngineCondemned(f"{method}: this engine was replaced by the supervisor")
            index = st.index
            st.index += 1
            broadcast_object((_CALL, index, method, args, kwargs))
        out = getattr(self._engine, method)(*args, **kwargs)
        if st.record:
            st.log.append(dict(index=index, method=method, args=args, kwargs=kwargs, out=out))
        return out

    def batch_generate_json(self, *args, **kwargs):
        return self._call("batch_generate_json", *args, **kwargs)

    def batch_generate(self, *args, **kwargs):
        return self._call("batch_generate", *args, **kwargs)

    def generate(self, *args, **kwargs):
        return self._call("generate", *args, **kwargs)

    def wrap_factory(self, factory: Optional[Callable]) -> Optional[Callable]:
        """The supervisor's engine factory: the followers are told to
        rebuild theirs, this proxy is condemned (the hung call's thread,
        which holds it, can no longer reach the followers), and the fresh
        engine leads in a new proxy sharing this one's state."""
        if factory is None:
            return None

        def rebuild():
            with self._state.lock:
                broadcast_object((_REBUILD,))
                self._condemned = True
            fresh = MeshLeader(factory(), state=self._state)
            return fresh

        return rebuild

    def close(self) -> None:
        """End the followers' loops (once, whichever proxy closes)."""
        st = self._state
        with st.lock:
            if not st.closed:
                st.closed = True
                broadcast_object((_END,))

    def shutdown(self) -> None:
        self.close()
        self._engine.shutdown()


def follow(engine, engine_factory: Optional[Callable] = None, record: bool = False):
    """A follower rank's loop: make every call rank 0's scheduler
    dispatches, on ``engine``, until the leader closes.  A rebuild message
    replaces ``engine`` with ``engine_factory()``.  Returns the number of
    calls made, or with ``record`` the list of their outputs (an
    exception in a failed call's place)."""
    made, outputs = 0, []
    while True:
        msg = broadcast_object(None)
        if msg[0] == _END:
            return outputs if record else made
        if msg[0] == _REBUILD:
            if engine_factory is None:
                raise RuntimeError("the serving leader rebuilt its engine, and this "
                                   "follower was given no engine_factory")
            engine = engine_factory()
            continue
        _, _index, method, args, kwargs = msg
        if method not in _METHODS:
            raise ValueError(f"serving follower: unknown engine call {method!r}")
        try:
            out = getattr(engine, method)(*args, **kwargs)
        except Exception as e:   # the leader's call fails alike; it retries
            out = e
        made += 1
        if record:
            outputs.append(out)
