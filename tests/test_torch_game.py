"""Game-level parity: a whole game through ``bcg_tpu_torch``'s
``BCGSimulation`` and ``TorchEngine`` (CPU, plain kernel versions)
against the JAX package's ``BCGSimulation`` and ``JaxEngine`` on the same
weights.

2 honest + 1 Byzantine agents, ``max_rounds=2``, ``seed=3``, greedy
decisions and votes on ``bcg-tpu/tiny-test``.  Greedy decoding makes the
game deterministic, so the two runs must agree exactly — per-round
decisions and votes, the termination reason and the whole statistics
payload ``run()`` returns — with no tolerance.  The weights come from
``PRNGKey(5)``: with them the first vote goes on and the game plays both
rounds, so the second round's prompts (received proposals, history) are
compared too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation
import _torch_jax_obs_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pools spinning
    against each other slow these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


MODEL = "bcg-tpu/tiny-test"


def _config(C, backend):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=2, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048),
        llm=C.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
        metrics=C.MetricsConfig(save_results=False),
    )


def named_arrays(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", a) for i, l in enumerate(v) for n, a in l.items()]
        else:
            out.append((k, v))
    return [(n, np.asarray(a)) for n, a in out]


def _play(sim):
    """Run the game, recording each round's votes as the round closes."""
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    decisions = [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds]
    return stats, decisions, votes


@pytest.fixture(scope="module")
def games():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    jc, tc = _config(jcfg, "jax"), _config(tcfg, "torch")
    jsim = JSimulation(jc, engine=JaxEngine(jc.engine, params=jp))
    tsim = TSimulation(tc, engine=TorchEngine(tc.engine, device="cpu", params=tp))
    return (jsim,) + _play(jsim), (tsim,) + _play(tsim)


def test_statistics_identical(games):
    (_, jstats, _, _), (_, tstats, _, _) = games
    assert tstats == jstats
    assert len(tstats) > 40 and tstats["total_rounds"] >= 1


def test_decisions_votes_and_termination_identical(games):
    (jsim, _, jdec, jvotes), (tsim, _, tdec, tvotes) = games
    assert tdec == jdec
    assert tvotes == jvotes
    assert len(tvotes) == len(tdec) == 2
    assert tsim.game.termination_reason == jsim.game.termination_reason is not None
    assert tsim.engine.failed_rows == jsim.engine.failed_rows == 0
