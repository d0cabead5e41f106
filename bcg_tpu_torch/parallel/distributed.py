"""Multi-process runtime over ``torch.distributed`` — the port of
``bcg_tpu/parallel/distributed.py``.

The reference is one JAX controller per host over many devices, with
XLA inserting the collectives.  The port follows PyTorch's own model: one
process per rank, one device per rank, explicit collectives on each mesh
dimension's process group (:mod:`bcg_tpu_torch.parallel.collectives`).
:func:`initialize` joins (or creates) the world, :func:`build_hybrid_mesh`
keeps every tp/sp group inside one host, and :func:`spawn_world` starts
an N-rank world of subprocesses on this host (the tests' worlds on the
CPU, ``chip_smoke.py``'s two ranks on one card).

Backend choice: NCCL when each rank of this host owns a card; gloo on the
CPU (asked for with ``device_type='cpu'``) or when the host runs more
ranks than it has cards (NCCL refuses two ranks on one device).  The
choice is printed once per rank; nothing falls back silently: a CUDA
world on a host without a card raises.
"""

from __future__ import annotations

import atexit
import datetime
import importlib
import json
import os
import selectors
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from bcg_tpu_torch.parallel.mesh import build_mesh

# A collective that waits longer than this raises instead of hanging.
DEFAULT_TIMEOUT_S = 600.0

_state: Dict[str, object] = {"initialized": False, "device": None, "local_world": 1}


def _device_and_backend(device_type: str, local_rank: int, local_world: int,
                        local_device_ids: Optional[Sequence[int]],
                        backend: Optional[str]):
    """This rank's device and the world's backend, with the reason.  A
    CUDA world without a card raises: a rank never drops to the CPU on
    its own."""
    if device_type == "cpu":
        return torch.device("cpu"), backend or "gloo", "the CPU requested: gloo"
    if device_type != "cuda":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.distributed world on CUDA: no CUDA device is available; "
                           "pass device_type='cpu' (the CLI's --device cpu) to run on the CPU")
    n_cards = torch.cuda.device_count()
    idx = int(local_device_ids[0]) if local_device_ids else local_rank % n_cards
    if local_world > n_cards:
        why = f"{local_world} ranks share {n_cards} card(s) on this host: gloo"
        return torch.device("cuda", idx), backend or "gloo", why
    return torch.device("cuda", idx), backend or "nccl", "one card per rank: nccl"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device_type: str = "cuda",
) -> None:
    """Join (or create) the process group; idempotent.

    With no arguments the world comes from ``env://`` (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``, as ``torchrun``
    sets them).  ``coordinator_address`` is ``host:port`` (TCP) or a
    ``file://`` / ``tcp://`` init method.  The rank's device is
    ``cuda:LOCAL_RANK`` (``local_device_ids[0]`` when given; ranks past the
    host's card count share cards round-robin); with no card it raises.
    ``device_type='cpu'`` puts the rank on the CPU (gloo).  ``timeout_s`` bounds every collective of the world.  Registers
    :func:`shutdown` at exit — the analogue of the reference's
    ``destroy_process_group`` teardown."""
    if _state["initialized"]:
        return
    env = os.environ
    world = num_processes if num_processes is not None else int(env.get("WORLD_SIZE", 1))
    rank = process_id if process_id is not None else int(env.get("RANK", 0))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    device, backend, why = _device_and_backend(device_type, local_rank, local_world,
                                               local_device_ids, backend)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    print(f"[bcg_tpu_torch.parallel] rank {rank}/{world} on {device}: backend {backend} "
          f"({why})", file=sys.stderr, flush=True)
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    _state.update(initialized=True, device=device, local_world=local_world)
    # The observability plane's process identity, read lazily.
    from bcg_tpu_torch.obs import fleet

    fleet.set_process_provider(lambda: (dist.get_rank(), dist.get_world_size()))
    atexit.register(shutdown)


def shutdown() -> None:
    """Destroy the process group (idempotent)."""
    if _state["initialized"]:
        if dist.is_initialized():
            dist.destroy_process_group()
        _state.update(initialized=False, device=None, local_world=1)


def device() -> torch.device:
    """This rank's device (:func:`initialize` chose it); raises before a
    world exists."""
    if not _state["initialized"]:
        raise RuntimeError("torch.distributed world not initialized "
                           "(bcg_tpu_torch.parallel.distributed.initialize)")
    return _state["device"]


def world_size() -> int:
    """Ranks in the world: 1 when none was initialized."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_info() -> dict:
    """Cluster shape summary for logs and metrics (one device a rank)."""
    init = dist.is_initialized()
    return {
        "process_index": dist.get_rank() if init else 0,
        "process_count": dist.get_world_size() if init else 1,
        "local_device_count": 1,
        "local_process_count": int(_state["local_world"]),
        "global_device_count": dist.get_world_size() if init else 1,
        "backend": dist.get_backend() if init else None,
    }


def build_hybrid_mesh(tp: int = 1, sp: int = 1, dp: Optional[int] = None):
    """dp x tp x sp mesh whose tp and sp groups stay inside one host while
    dp spans hosts.  Ranks are numbered host-major (as ``torchrun`` numbers
    them), so reshaping them to (dp, tp, sp) keeps every tp/sp group on
    one host exactly when tp*sp divides the ranks of a host.  ``dp``
    defaults to every remaining rank."""
    world = world_size()
    inner = tp * sp
    n_local = int(_state["local_world"])
    if world > n_local and (inner > n_local or n_local % inner != 0):
        raise ValueError(
            f"tp*sp={inner} does not pack into the {n_local} ranks of one host; "
            "a tp/sp collective group would cross hosts — resize them or move the "
            "extra parallelism to dp"
        )
    if dp is None:
        if world % inner:
            raise ValueError(f"{world} ranks not divisible by tp*sp={inner}")
        dp = world // inner
    return build_mesh(dp=dp, tp=tp, sp=sp)


def mesh_spans_processes(mesh) -> bool:
    """True when the mesh holds more than one rank — in the port every
    rank is a process, so any mesh of size > 1 spans processes."""
    return mesh is not None and mesh.size() > 1


# ------------------------------------------------------------ local worlds

class WorldFailed(RuntimeError):
    """A rank of a :func:`spawn_world` world failed or overran its limit."""


def _tail(path: str, n: int = 4000) -> str:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        f.seek(max(0, f.tell() - n))
        return f.read().decode("utf-8", "replace")


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def spawn_world(target: str, nprocs: int, *, timeout_s: float, args: Optional[dict] = None,
                sys_path: Sequence[str] = (), device_type: str = "cuda",
                device_ids: Optional[Sequence[int]] = None) -> List[str]:
    """Run ``target`` (``"module:function"``) on every rank of a fresh
    ``nprocs``-rank world of subprocesses on this host, and return each
    rank's output (stdout and stderr).

    Each rank imports only this package and ``target``'s module (nothing
    of the parent's), runs one intra-op thread (ranks share the host's
    cores), joins the
    world through a ``FileStore`` in a private temporary directory (no
    port, so concurrent worlds cannot collide) and calls
    ``function(**args)``.  Every rank shares one ``BCG_TPU_RUN_ID`` (the
    parent's, else a fresh one).  ``device_type``: the ranks' device type
    (:func:`initialize`'s); ``device_ids``: each rank's CUDA device
    (default ``LOCAL_RANK`` modulo the cards).  The world has a hard wall
    limit of ``timeout_s``: past it, or as soon as one rank fails, every
    rank is killed (its process group) and :class:`WorldFailed` carries
    the failing rank's output."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    tmp = tempfile.mkdtemp(prefix="bcg_world_")
    # One run id for every rank of the world (the fleet identity, which
    # the cooperative sweep matches rank 0's plan by), unless the parent
    # set one.
    run_id = uuid.uuid4().hex[:12]
    procs, logs = [], []
    # Each rank holds the write end of a pipe it never writes: the read end
    # turns readable (EOF) when the rank exits, so the parent waits on the
    # ranks' exits, not on a clock.
    exits = selectors.DefaultSelector()
    try:
        for rank in range(nprocs):
            rank_env = dict(os.environ)
            rank_env.setdefault("BCG_TPU_RUN_ID", run_id)
            rank_env.update(
                RANK=str(rank), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(rank),
                LOCAL_WORLD_SIZE=str(nprocs), OMP_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join([root, *sys_path,
                                            rank_env.get("PYTHONPATH", "")]).rstrip(os.pathsep),
            )
            log = os.path.join(tmp, f"rank{rank}.log")
            logs.append(log)
            cmd = [sys.executable, "-c",
                   "from bcg_tpu_torch.parallel.distributed import _rank_main; _rank_main()",
                   os.path.join(tmp, "store"), target, json.dumps(args or {}), device_type,
                   json.dumps(None if device_ids is None else int(device_ids[rank]))]
            read_end, write_end = os.pipe()
            with open(log, "wb") as out:
                procs.append(subprocess.Popen(cmd, env=rank_env, stdout=out,
                                              stderr=subprocess.STDOUT,
                                              start_new_session=True, pass_fds=(write_end,)))
            os.close(write_end)
            exits.register(read_end, selectors.EVENT_READ, rank)
        deadline = time.monotonic() + timeout_s
        while exits.get_map():
            ready = exits.select(timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                _kill(procs)
                live = sorted(key.data for key in exits.get_map().values())
                raise WorldFailed(f"world of {nprocs} ({target}) passed its limit of "
                                  f"{timeout_s:.0f} s; ranks {live} were killed:\n"
                                  f"{_tail(logs[live[0]])}")
            for key, _ in ready:
                exits.unregister(key.fd)
                os.close(key.fd)
                code = procs[key.data].wait()
                if code:
                    _kill(procs)
                    raise WorldFailed(f"rank {key.data} of {nprocs} ({target}) exited with "
                                      f"{code}:\n{_tail(logs[key.data])}")
        return [_tail(log, 1 << 20) for log in logs]
    finally:
        _kill(procs)
        for key in list(exits.get_map().values()):
            os.close(key.fd)
        exits.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _rank_main() -> None:
    """A :func:`spawn_world` rank: ``argv`` = store path, target, JSON
    arguments, device type, JSON device id."""
    store, target, args, device_type, dev = sys.argv[1:6]
    torch.set_num_threads(1)
    dev = json.loads(dev)
    initialize(coordinator_address=f"file://{store}", device_type=device_type,
               local_device_ids=None if dev is None else [dev])
    try:
        resolve(target)(**json.loads(args))
    finally:
        shutdown()


def resolve(target: str):
    """The function a ``"module:function"`` name names."""
    module, fn = target.split(":")
    return getattr(importlib.import_module(module), fn)
