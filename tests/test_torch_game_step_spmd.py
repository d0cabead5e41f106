"""The SPMD game-step forms of ``bcg_tpu_torch.parallel.game_step``
(``exchange_values`` through ``shard_agents``) against the JAX package's
single-process forms on a dp mesh of the same size (ROADMAP C-ref-3: not
against ``exchange_values_global``).

The port's forms run in one gloo world of 2 ranks for the module
(``tests/_torch_parallel_worker.game_step_cases``), each rank holding its
half of the agents; their outputs are put back together by rank.  The JAX
forms run on two of the conftest's virtual CPU devices.  Cases: fully
connected, ring and asymmetric topologies with abstainers, an
equivocating sender's per-receiver matrix, votes around the 2/3 line, a
consensus and a disagreement, and an agent count the mesh cannot split.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from bcg_tpu.comm import NetworkTopology
from bcg_tpu.parallel import game_step as jgs
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu_torch.parallel.distributed import spawn_world
import _torch_jax_obs_state

TESTS = os.path.dirname(os.path.abspath(__file__))
DP = 2


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


def _case(name, n, topology, values, votes, byz, equivocator=None):
    if topology == "asymmetric":
        mask = np.random.default_rng(3).random((n, n)) < 0.4
    else:
        mask = getattr(NetworkTopology, topology)(n).neighbor_mask().T.copy()
    values = np.asarray(values, np.int32)
    matrix = np.broadcast_to(values[None, :], (n, n)).copy()
    if equivocator is not None:
        matrix[:, equivocator] = (values[equivocator] + np.arange(n)) % 51
    inits = np.where(byz, -1, values).astype(np.int32)
    return dict(name=name), dict(mask=mask, values=values, matrix=matrix.astype(np.int32),
                                 votes=np.asarray(votes, np.int32), byz=np.asarray(byz),
                                 inits=inits)


def _cases():
    rng = np.random.default_rng(0)
    n = 8
    vals = rng.integers(0, 51, n).astype(np.int32)
    vals[1] = -1
    byz = np.zeros(n, bool)
    byz[[6, 7]] = True
    return [
        _case("full", n, "fully_connected", vals, [1] * 6 + [0, -1], byz),
        _case("ring", n, "ring", vals, [1, 0] * 4, byz, equivocator=6),
        _case("asymmetric", 16, "asymmetric", rng.integers(-1, 51, 16), [1] * 11 + [0] * 5,
              np.arange(16) >= 13),
        _case("consensus", n, "fully_connected", np.where(byz, 3, 17), [1] * 8, byz),
        (dict(name="indivisible", indivisible=True), dict(mask=np.ones((7, 7), bool))),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("game_step"))
    inputs = os.path.join(tmp, "inputs")
    cases = _cases()
    np.savez(inputs + ".npz", **{f"{s['name']}/{k}": v for s, a in cases for k, v in a.items()})
    with open(inputs + ".json", "w") as f:
        json.dump([s for s, _ in cases], f)
    spawn_world("_torch_parallel_worker:game_step_cases", DP, timeout_s=120,
                args=dict(inputs=inputs, out=tmp), sys_path=[TESTS], device_type="cpu")
    return [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(DP)]


NAMES = ["full", "ring", "asymmetric", "consensus"]


def _arrays(name):
    return next(a for s, a in _cases() if s["name"] == name)


@pytest.mark.parametrize("name", NAMES)
def test_exchange_values_and_proposals_match_jax(ranks, name):
    a = _arrays(name)
    mesh = j_build_mesh(dp=DP)
    want = np.asarray(jgs.exchange_values(jnp.asarray(a["values"]), jnp.asarray(a["mask"]), mesh))
    got = np.concatenate([r[f"{name}/received"] for r in ranks])
    np.testing.assert_array_equal(got, want)
    want_m = np.asarray(jgs.exchange_proposals(jnp.asarray(a["matrix"]),
                                               jnp.asarray(a["mask"]), mesh))
    np.testing.assert_array_equal(np.concatenate([r[f"{name}/matrix"] for r in ranks]), want_m)


@pytest.mark.parametrize("name", NAMES)
def test_tally_and_consensus_match_jax(ranks, name):
    a = _arrays(name)
    mesh = j_build_mesh(dp=DP)
    tally = jgs.tally_votes(jnp.asarray(a["votes"]), mesh)
    want = [int(tally[k]) for k in ("stop", "continue", "abstain", "terminate", "half_stop")]
    cons = jgs.check_consensus_spmd(jnp.asarray(a["values"]), jnp.asarray(a["byz"]),
                                    jnp.asarray(a["inits"]), mesh)
    want_c = [float(cons["has_consensus"]), float(cons["consensus_value"]),
              float(cons["agreement_pct"])]
    for r in ranks:  # every rank holds the global answer
        assert r[f"{name}/tally"].tolist() == want
        np.testing.assert_allclose(r[f"{name}/consensus"], want_c, rtol=1e-6)
    received, tally2, cons2 = jgs.spmd_round_arrays(
        jnp.asarray(a["values"]), jnp.asarray(a["votes"]), jnp.asarray(a["mask"]),
        jnp.asarray(a["byz"]), jnp.asarray(a["inits"]), mesh)
    np.testing.assert_array_equal(np.concatenate([r[f"{name}/round_received"] for r in ranks]),
                                  np.asarray(received))
    for r in ranks:
        assert int(r[f"{name}/round_stop"]) == int(tally2["stop"])
        assert bool(r[f"{name}/round_consensus"]) == bool(cons2["has_consensus"])


def test_shard_agents_refuses_indivisible_counts(ranks):
    assert all(int(r["indivisible"]) == 1 for r in ranks)
    with pytest.raises(ValueError, match="divisible"):
        jgs.shard_agents(7, j_build_mesh(dp=DP))
