"""The paged KV pool over a mesh of two ranks (ROADMAP A13b item 3): bf16,
int8 and int4 pools under tp and dp, over two rounds whose second extends
the first's radix chains, against the JAX engine on the same mesh shape.

Under tp a rank's pool holds its kv heads; the block tables, the
allocator and the radix index are the same on every rank.  Under dp the
pool replicates: every rank assembles the whole batch's tables and takes
every row's writes (gathered over dp), so the ranks' pools stay equal —
were a rank to write only its own rows, a later round's radix hit on the
other rank would read a block it never wrote.  The port's arms run in one
gloo world of 2 ranks started once for the module
(``tests/_torch_parallel_worker.knob_cases``), on ``tiny-test``
(``PRNGKey(5)``) and ``tiny-dh128`` (``PRNGKey(1)``), the JAX
initializer's weights in f32 on both sides.  Held, after each round:

* the greedy outputs, token for token, against ``JaxEngine`` on the same
  mesh, and the same on every rank;
* the pool's free and resident blocks and its prefix hit rate against
  the JAX pool's, on every rank;
* under dp, the two ranks' pools byte for byte (a digest of every
  layer's blocks).
"""

import json

import pytest
import torch

import _torch_jax_obs_state
import _torch_knob_harness as h

ARMS = [h.arm("P5", mesh, model=model, rounds=2, **kv)
        for mesh in ("tp", "dp")
        for model, kv in ((h.TT, {}), (h.TT, dict(kv_cache_dtype="int8")),
                          (h.DH, dict(kv_cache_dtype="int4")))]
for a in ARMS:
    a["name"] += "_" + a["kw"].get("kv_cache_dtype", "bf16")
# The paged paths with the other loops, under the mesh each composes with.
ARMS += [h.arm("P6", "dp", rounds=2), h.arm("P7", "tp", rounds=2)]
PROMPTS = h.round_prompts(2)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return h.jax_weights((h.TT, h.DH))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    return h.run_world(str(tmp_path_factory.mktemp("paged")), ARMS, weights, PROMPTS)


@pytest.fixture(scope="module")
def jax_runs(weights):
    return {a["name"]: h.jax_rounds(a, weights[a["model"]], PROMPTS) for a in ARMS}


@pytest.mark.parametrize("arm", ARMS, ids=[a["name"] for a in ARMS])
def test_rounds_equal_jax_pool_and_outputs(ranks, jax_runs, arm):
    want = jax_runs[arm["name"]]
    assert len(want) == 2
    for res in ranks[arm["name"]]:
        assert int(res["failed"]) == 0
        for i, (results, pool) in enumerate(want):
            assert json.loads(str(res[f"r{i}"])) == results, f"round {i + 1}"
            assert json.loads(str(res[f"pool{i}"])) == pool, f"round {i + 1}"
    # The second round extends the first's radix chains.
    assert want[1][1]["prefix_hit_rate"] > 0


@pytest.mark.parametrize("arm", [a for a in ARMS if a["mesh"] == "dp"],
                         ids=[a["name"] for a in ARMS if a["mesh"] == "dp"])
def test_dp_ranks_pools_equal_after_each_round(ranks, arm):
    r0, r1 = ranks[arm["name"]]
    for i in range(arm["rounds"]):
        assert str(r0[f"digest{i}"]) == str(r1[f"digest{i}"]), f"round {i + 1}"
