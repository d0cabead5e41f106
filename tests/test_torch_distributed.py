"""``bcg_tpu_torch.parallel.distributed``, ``mesh`` and ``collectives``
over a real 2-rank gloo world on the CPU, as ``tests/test_multihost.py``
holds the JAX package's: ``initialize`` joins the world (a ``FileStore``
rendezvous), ``process_info`` and the fleet identity report it, the hybrid
mesh refuses a tp group that would straddle hosts, the collectives give
each rank the right values (and count themselves), and ``shutdown`` leaves
no process group.  ``spawn_world``'s wall limit kills a world that hangs,
and a failing rank fails its world at once.
"""

import os
import time

import numpy as np
import pytest
import torch

from bcg_tpu_torch.parallel import distributed
from bcg_tpu_torch.parallel.mesh import build_mesh, mesh_shape

TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("runtime"))
    logs = distributed.spawn_world("_torch_parallel_worker:runtime_cases", 2, timeout_s=120,
                                   args=dict(out=out), sys_path=[TESTS], device_type="cpu")
    return out, logs, [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]


def test_initialize_process_info_and_fleet_identity(ranks):
    _, logs, res = ranks
    for r, (log, got) in enumerate(zip(logs, res)):
        assert got["info"].tolist() == [r, 2, 1, 2]
        assert str(got["backend"]) == "gloo"
        assert got["fleet"].tolist() == [r, 2]
        # The backend choice is logged, with its reason.
        assert f"rank {r}/2 on cpu: backend gloo (the CPU requested" in log


def test_a_mesh_engine_without_a_device_needs_a_card(ranks):
    """The rank's world is on the CPU, but an engine that names no device
    asks for CUDA: without a card it raises, never dropping to the CPU."""
    _, _, res = ranks
    for got in res:
        assert "no CUDA device is available" in str(got["unnamed_device"])


def test_a_cuda_world_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        distributed.initialize(coordinator_address="file:///nonexistent/store",
                               num_processes=2, process_id=0)
    assert not distributed._state["initialized"]
    device, backend, why = distributed._device_and_backend("cpu", 0, 2, None, None)
    assert (device.type, backend) == ("cpu", "gloo") and "CPU requested" in why


def test_hybrid_mesh_and_its_refusal(ranks):
    _, _, res = ranks
    for got in res:
        assert got["mesh"].tolist() == [1, 2, 1]
        assert bool(got["spans"])
        assert int(got["refused"]) == 1


def test_collectives_values_and_counters(ranks):
    _, _, res = ranks
    for r, got in enumerate(res):
        assert got["gather"].tolist() == [0.0, 0.0, 1.0, 1.0]
        assert got["reduce_max"].tolist() == [1.0, 1.0]
        assert got["shift"].tolist() == [float(1 - r)] * 2
        # One gather counted; nothing staged for CPU tensors.
        assert got["counted"].tolist() == [1, 0]
        assert got["single"].tolist() == [float(r)] * 2


def test_shutdown_leaves_no_process_group(ranks):
    out, _, _ = ranks
    for r in range(2):
        assert np.load(os.path.join(out, f"after{r}.npy")).tolist() == [0, 1]


def test_mesh_without_a_world():
    assert mesh_shape(None) == {"dp": 1, "tp": 1, "sp": 1}
    with pytest.raises(ValueError, match="needs a world of 2 ranks, have 1"):
        build_mesh(tp=2)
    with pytest.raises(RuntimeError, match="not initialized"):
        distributed.device()


def test_a_hanging_world_is_killed_at_its_limit():
    t0 = time.monotonic()
    with pytest.raises(distributed.WorldFailed, match="passed its limit of 3 s"):
        distributed.spawn_world("_torch_parallel_worker:hang", 2, timeout_s=3,
                                args=dict(seconds=120), sys_path=[TESTS], device_type="cpu")
    assert time.monotonic() - t0 < 30


def test_a_failing_rank_fails_its_world_at_once():
    t0 = time.monotonic()
    with pytest.raises(distributed.WorldFailed, match="rank 1 fails on purpose"):
        distributed.spawn_world("_torch_parallel_worker:fail_on_rank", 2, timeout_s=120,
                                args=dict(rank=1), sys_path=[TESTS], device_type="cpu")
    assert time.monotonic() - t0 < 40
