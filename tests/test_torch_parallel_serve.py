"""``ServingEngine`` over an engine on a mesh of two ranks (ROADMAP A13b
item 5): rank 0 runs the one scheduler and leads, the other rank follows
its dispatches (``bcg_tpu_torch/serve/mesh.py``).

The port's arms run in one gloo world of 2 ranks started once for the
module (``tests/_torch_parallel_worker.serve_cases``) on ``tiny-test``
(``PRNGKey(5)``, f32 weights), each playing two greedy games of
``tests/test_torch_serve.py``'s kind (2 honest + 1 Byzantine, one round)
behind the scheduler.  Held:

* over a dp 2 and a tp 2 engine, the games equal the JAX serving tier's
  (``ServingEngine`` over ``JaxEngine`` on the same mesh), at least one
  dispatch merges the two games' rows, and both ranks' outputs are the
  same, dispatch by dispatch;
* ``crash@serve.dispatch:1`` on the dp engine: the leader retries, the
  follower never sees the failed attempt, the games are the fault-free
  arm's;
* ``hang@serve.dispatch:2`` past the watchdog on the tp engine: the
  supervisor's one rebuild reaches the follower (each rank builds one
  fresh engine), the hung call's thread can no longer send, and the
  games are the fault-free arm's;
* ``shutdown()`` ends the follower's loop: every world returns, each
  follower having made exactly the leader's calls.
"""

import json
import os

import pytest
import torch

import bcg_tpu.config as jcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu.serve import ServingEngine as JServingEngine, run_serving_simulations as j_run
from bcg_tpu_torch.parallel.distributed import spawn_world
import _torch_jax_obs_state
import _torch_knob_harness as h

SEEDS = (3, 4)
LLM = dict(temperature_decide=0.0, temperature_vote=0.0, max_tokens_decide=96,
           max_tokens_vote=48)
ARMS = [
    dict(name="dp", kw=dict(data_parallel_size=2)),
    dict(name="tp", kw=dict(tensor_parallel_size=2)),
    dict(name="dp_crash", kw=dict(data_parallel_size=2), chaos="crash@serve.dispatch:1",
         retries=2),
    dict(name="tp_rebuild", kw=dict(tensor_parallel_size=2),
         chaos="hang@serve.dispatch:2:12", watchdog_s=8),
]


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
    return h.jax_weights((h.TT,))[h.TT]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    import numpy as np

    tmp = str(tmp_path_factory.mktemp("serve"))
    inputs = os.path.join(tmp, "inputs")
    np.savez(f"{inputs}_tiny-test.npz", **dict(h.named(weights)))
    with open(inputs + ".json", "w") as f:
        json.dump(dict(model=h.TT, arms=ARMS, seeds=SEEDS, llm=LLM), f)
    out = os.path.join(tmp, "world")
    os.makedirs(out)
    spawn_world("_torch_parallel_worker:serve_cases", 2, timeout_s=300,
                args=dict(inputs=inputs, out=out), sys_path=[h.TESTS], device_type="cpu")
    per_rank = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    return {a["name"]: [{k.split("/", 1)[1]: v for k, v in r.items()
                         if k.startswith(a["name"] + "/")} for r in per_rank] for a in ARMS}


def _jax_games(weights, kw):
    ecfg = jcfg.EngineConfig(backend="jax", model_name=h.TT, max_model_len=2048, **kw)
    engine = JaxEngine(ecfg, mesh=h.jax_mesh(kw), params=weights)

    def game(seed):
        def run(served):
            cfg = jcfg.BCGConfig(
                game=jcfg.GameConfig(num_honest=2, num_byzantine=1, max_rounds=1, seed=seed),
                engine=ecfg, llm=jcfg.LLMConfig(**LLM),
                metrics=jcfg.MetricsConfig(save_results=False))
            sim = JSimulation(cfg, engine=served)
            stats = sim.run()
            decisions = [[r.round_num, dict(r.agent_values)] for r in sim.game.rounds]
            sim.close()
            return dict(stats=stats, decisions=decisions)
        return run

    serving = JServingEngine(engine, linger_ms=50)
    try:
        games = j_run(engine, [game(s) for s in SEEDS], serving=serving)
    finally:
        serving.shutdown()
        engine.shutdown()
    return json.loads(json.dumps(games, sort_keys=True, default=str))


def _games(res):
    return json.loads(str(res["games"]))


@pytest.mark.parametrize("name", ["dp", "tp"])
def test_served_games_equal_the_jax_serving_tier(ranks, weights, name):
    leader, follower = ranks[name]
    arm = next(a for a in ARMS if a["name"] == name)
    assert _games(leader) == _jax_games(weights, arm["kw"])
    stats = json.loads(str(leader["stats"]))
    assert stats["merged_dispatches"] >= 1 and stats["failed"] == 0
    assert json.loads(str(leader["outputs"])) == json.loads(str(follower["outputs"]))
    assert int(leader["failed"]) == int(follower["failed"]) == 0


@pytest.mark.parametrize("name,clean", [("dp_crash", "dp"), ("tp_rebuild", "tp")])
def test_followers_survive_a_fault_on_the_leader(ranks, name, clean):
    leader, follower = ranks[name]
    assert _games(leader) == _games(ranks[clean][0])
    stats = json.loads(str(leader["stats"]))
    recovery = stats["recovery"]
    assert recovery["dispatch_retries"] >= 1 and recovery["recoveries"] >= 1
    assert stats["failed"] == 0
    # The follower made exactly the leader's calls, with its outputs.
    assert json.loads(str(leader["outputs"])) == json.loads(str(follower["outputs"]))
    rebuilt = 1 if name == "tp_rebuild" else 0
    assert recovery["engine_rebuilds"] == rebuilt
    assert int(leader["rebuilt"]) == int(follower["rebuilt"]) == rebuilt
