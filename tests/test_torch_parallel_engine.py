"""``TorchEngine`` over a mesh (ROADMAP A13a: the default engine under tp,
sp and dp) against the port's one-rank engine and the JAX package on the
same mesh shape.

The port's engines run in a gloo world of 2 ranks (tp 2, sp 2 and dp 2 on
``tiny-test`` and ``tiny-dh128``) and one of 4 (dp x tp 2 x 2 on
``tiny-test``), each world started once for the module
(``tests/_torch_parallel_worker.engine_cases``).  Weights are the JAX
initializer's, f32 on both sides (``PRNGKey(5)`` for tiny-test, whose
greedy game plays both rounds, as in ``tests/test_torch_game.py``;
``PRNGKey(1)`` for tiny-dh128).  Held:

* the sharded model's prefill and decode-step logits on fixed tokens
  against the JAX model over the same mesh (GSPMD shards, ring attention
  under sp) and against the port's one-rank model;
* every prefill and decode step of a greedy ``batch_generate_json``
  (decision and vote schemas) against the one-rank engine's;
* the greedy outputs token for token against ``JaxEngine`` on the same
  mesh, and every rank's outputs identical;
* a whole 8H+2B greedy game of one round on tiny-test under tp, sp and
  dp (``spmd_exchange`` in the dp arm): statistics, decisions, votes and
  termination equal to the JAX game on the same mesh, and the same on
  every rank.

Tolerances are C-port-1's: prefill logits 1e-4, decode-step logits 1e-2
(a bf16 cache entry flips at a rounding boundary when a sum runs in
another order).  Under sp the decode steps merge the slices in f32 and
return the query's type, as the JAX ring functions do, where one device
rounds the attention output to the cache's bf16 (C-port-8): those steps
are held to the JAX model at 1e-4 and to the one-rank model at
``SP_DECODE_TOL``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu.parallel.sharding import shard_params as j_shard_params
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch import config as tcfg
from bcg_tpu_torch.engine import torch_engine as te
from bcg_tpu_torch.models import transformer as T
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.parallel.distributed import spawn_world
import _torch_jax_obs_state
import _torch_parallel_worker as worker

TESTS = os.path.dirname(os.path.abspath(__file__))
PREFILL_TOL, DECODE_TOL, SP_DECODE_TOL = 1e-4, 1e-2, 5e-2
KEYS = {"bcg-tpu/tiny-test": 5, "bcg-tpu/tiny-dh128": 1}

VOTE_SCHEMA = {
    "type": "object",
    "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
    "required": ["decision"],
    "additionalProperties": False,
}
DECISION_SCHEMA = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 30},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
        "public_reasoning": {"type": "string", "minLength": 1, "maxLength": 30},
    },
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False,
}
PROMPTS = [
    (f"You are agent_{i % 2}. Reach consensus.",
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION_SCHEMA if i % 2 else VOTE_SCHEMA)
    for i in range(6)
]


def _arm(model, dp=1, tp=1, sp=1, game=False):
    short = model.split("/")[-1]
    return dict(name=f"{short}_dp{dp}tp{tp}sp{sp}", model=model, dp=dp, tp=tp, sp=sp, game=game)


TT, DH = "bcg-tpu/tiny-test", "bcg-tpu/tiny-dh128"
ARMS2 = [_arm(TT, tp=2, game=True), _arm(TT, sp=2, game=True), _arm(TT, dp=2, game=True),
         _arm(DH, tp=2), _arm(DH, sp=2), _arm(DH, dp=2)]
ARMS4 = [_arm(TT, dp=2, tp=2)]
ARMS = ARMS2 + ARMS4
GAME_ARMS = [a for a in ARMS if a["game"]]
# Every arm is held to the JAX package over the same mesh shape,
# tiny-dh128's too (one kv head: q heads split, kv heads replicated
# under tp).
JAX_ARMS = ARMS


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


def _named(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", np.asarray(a)) for i, l in enumerate(v)
                    for n, a in l.items()]
        else:
            out.append((k, np.asarray(v)))
    return out


@pytest.fixture(scope="module")
def jax_params():
    return {m: jt.init_params(j_spec(m), jax.random.PRNGKey(k), dtype=jnp.float32)
            for m, k in KEYS.items()}


@pytest.fixture(scope="module")
def fixed_tokens():
    rng = np.random.default_rng(4)
    tokens = rng.integers(3, 500, (4, 16)).astype(np.int32)
    valid = np.ones((4, 16), bool)
    valid[0, :5] = False
    valid[2, :9] = False
    return tokens, valid


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params, fixed_tokens):
    """Each world's ranks' results: ``{arm name: [rank results]}``."""
    tmp = str(tmp_path_factory.mktemp("engine"))
    inputs = os.path.join(tmp, "inputs")
    for model, jp in jax_params.items():
        np.savez(f"{inputs}_{model.split('/')[-1]}.npz", **dict(_named(jp)))
    np.savez(inputs + "_tokens.npz", tokens=fixed_tokens[0], valid=fixed_tokens[1])
    out = {}
    for n, arms in ((2, ARMS2), (4, ARMS4)):
        with open(inputs + ".json", "w") as f:
            json.dump(dict(arms=arms, prompts=PROMPTS), f)
        d = os.path.join(tmp, f"world{n}")
        os.makedirs(d)
        spawn_world("_torch_parallel_worker:engine_cases", n, timeout_s=300,
                    args=dict(inputs=inputs, out=d), sys_path=[TESTS], device_type="cpu")
        per_rank = [dict(np.load(os.path.join(d, f"rank{r}.npz"))) for r in range(n)]
        for arm in arms:
            out[arm["name"]] = [{k.split("/", 1)[1]: v for k, v in r.items()
                                 if k.startswith(arm["name"] + "/")} for r in per_rank]
    return out


@pytest.fixture(scope="module")
def one_rank(jax_params, fixed_tokens):
    """The port's one-rank engine and model on the same weights."""
    out = {}
    tokens, valid = (torch.from_numpy(a) for a in fixed_tokens)
    for model, jp in jax_params.items():
        spec = spec_for_model(model)
        params = params_from_numpy(_named(jp), spec, "cpu", torch.float32)
        B, L = tokens.shape
        cache = T.init_kv_cache(spec, B, L + 4, torch.bfloat16)
        prefill, cache = T.prefill(params, spec, tokens.long(), valid, cache)
        vm = torch.zeros(B, L + 4, dtype=torch.bool)
        vm[:, :L] = valid
        vm[:, L] = True
        step, _ = T.decode_step(params, spec, torch.arange(B) + 3, L, valid.sum(1).int(), cache,
                                vm)
        engine = te.TorchEngine(tcfg.EngineConfig(backend="torch", model_name=model,
                                                  max_model_len=2048), device="cpu",
                                params=params)
        log = []
        saved = worker._record(te, ("prefill", "prefill_with_prefix", "decode_step"), log)
        try:
            results = engine.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
        finally:
            for n, f in saved.items():
                setattr(te, n, f)
        out[model] = dict(prefill=prefill.numpy(), decode=step.numpy(), results=results,
                          log=log)
    return out


def _rows(arm, rank_res, full):
    """The rows of ``full`` (a whole batch's) that a rank computed."""
    if arm["dp"] == 1:
        return full
    return np.split(full, arm["dp"])[rank_res["dp_rank"]] if "dp_rank" in rank_res else full


def _dp_rank(arm, r):
    """A rank's dp coordinate: ranks are numbered (dp, tp, sp)-major."""
    return r // (arm["tp"] * arm["sp"])


def _jax_model(arm, jax_params, fixed_tokens):
    """The JAX model's prefill and first decode-step logits over the arm's
    mesh (GSPMD-sharded weights; ring attention under sp)."""
    model = arm["model"]
    mesh = j_build_mesh(dp=arm["dp"], tp=arm["tp"], sp=arm["sp"])
    spec, jp = j_spec(model), jax_params[model]
    tokens, valid = (jnp.asarray(a) for a in fixed_tokens)
    B, L = tokens.shape
    cache = jt.init_kv_cache(spec, B, L + 4)
    if arm["sp"] > 1:
        j_prefill, cache = jt.prefill_sp(jp, spec, tokens, valid, cache, mesh)
        ring = (mesh, "sp")
    else:
        jp = j_shard_params(jp, spec, mesh)
        j_prefill, cache = jt.prefill(jp, spec, tokens, valid, cache)
        ring = None
    vm = jnp.zeros((B, L + 4), bool).at[:, :L].set(valid).at[:, L].set(True)
    j_step, _ = jt.decode_step(jp, spec, jnp.arange(B) + 3, jnp.int32(L),
                               valid.sum(1).astype(jnp.int32), cache, vm, ring=ring)
    return np.asarray(j_prefill), np.asarray(j_step)


@pytest.mark.parametrize("arm", ARMS, ids=[a["name"] for a in ARMS])
def test_model_logits_match_jax_and_one_rank(ranks, one_rank, jax_params, fixed_tokens, arm):
    model = arm["model"]
    B = fixed_tokens[0].shape[0]
    j_prefill = j_step = None
    if arm in JAX_ARMS:
        j_prefill, j_step = _jax_model(arm, jax_params, fixed_tokens)
    ref = one_rank[model]
    decode_tol = SP_DECODE_TOL if arm["sp"] > 1 else DECODE_TOL
    for r, res in enumerate(ranks[arm["name"]]):
        n = B // arm["dp"]
        rows = slice(_dp_rank(arm, r) * n, (_dp_rank(arm, r) + 1) * n)
        np.testing.assert_allclose(res["model_prefill"], ref["prefill"][rows],
                                   rtol=PREFILL_TOL, atol=PREFILL_TOL)
        if j_prefill is not None:
            np.testing.assert_allclose(res["model_prefill"], j_prefill[rows],
                                       rtol=PREFILL_TOL, atol=PREFILL_TOL)
            tol = DECODE_TOL if arm["sp"] == 1 else PREFILL_TOL
            np.testing.assert_allclose(res["model_decode"], j_step[rows], rtol=tol, atol=tol)
        np.testing.assert_allclose(res["model_decode"], ref["decode"][rows],
                                   rtol=decode_tol, atol=decode_tol)


@pytest.mark.parametrize("arm", ARMS, ids=[a["name"] for a in ARMS])
def test_engine_steps_match_one_rank_engine(ranks, one_rank, arm):
    """Each prefill and decode step of the greedy batch against the
    one-rank engine's: under tp and sp the same calls in the same order
    (a full prefill goes round the sp ring, a prefix-cached suffix through
    the sp chunk path); under dp each rank's decode steps hold its rows."""
    ref = one_rank[arm["model"]]["log"]
    kind = {"prefill": "prefill", "prefill_sp": "prefill", "prefill_with_prefix": "suffix",
            "prefill_chunk_at": "suffix", "decode_step": "decode"}
    decode_tol = SP_DECODE_TOL if arm["sp"] > 1 else DECODE_TOL
    for r, res in enumerate(ranks[arm["name"]]):
        calls = json.loads(str(res["calls"]))
        got = [(kind[c], res[f"call{i}"]) for i, c in enumerate(calls)]
        if arm["dp"] > 1:
            steps = [a for k, a in got if k == "decode"]
            want = [a for n, a in ref if n == "decode_step"]
            n = want[0].shape[0] // arm["dp"]
            rows = slice(_dp_rank(arm, r) * n, (_dp_rank(arm, r) + 1) * n)
            assert steps and len(steps) <= len(want)
            for a, b in zip(steps, want):
                np.testing.assert_allclose(a, b[rows], rtol=DECODE_TOL, atol=DECODE_TOL)
            continue
        want = [(kind[n], a) for n, a in ref]
        if arm["sp"] > 1:
            # The sp merge's f32 output can flip a near tie against one
            # device's bf16-rounded one, after which the rows' tokens (and
            # so their steps) part: the prefills and the first step only.
            first = next(i for i, (k, _) in enumerate(want) if k == "decode") + 1
            got, want = got[:first], want[:first]
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, a), (_, b) in zip(got, want):
            # Under sp a suffix attends the cache slices (its own k/v read
            # back from the bf16 cache), a decode step merges them (C-port-8).
            tol = PREFILL_TOL if k == "prefill" else decode_tol if k == "suffix" or \
                arm["sp"] > 1 else DECODE_TOL
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def jax_engines(jax_params):
    """``JaxEngine`` on each arm's mesh shape: greedy results, and the
    game where the arm plays one."""
    out = {}
    for arm in JAX_ARMS:
        mesh = j_build_mesh(dp=arm["dp"], tp=arm["tp"], sp=arm["sp"])
        ecfg = jcfg.EngineConfig(backend="jax", model_name=arm["model"], max_model_len=2048,
                                 tensor_parallel_size=arm["tp"],
                                 sequence_parallel_size=arm["sp"],
                                 data_parallel_size=arm["dp"])
        engine = JaxEngine(ecfg, mesh=mesh, params=jax_params[arm["model"]])
        res = dict(results=engine.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64))
        if arm["game"]:
            cfg = jcfg.BCGConfig(
                game=jcfg.GameConfig(num_honest=8, num_byzantine=2, max_rounds=1, seed=3),
                network=jcfg.NetworkConfig(spmd_exchange=arm["dp"] > 1),
                engine=ecfg,
                llm=jcfg.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
                metrics=jcfg.MetricsConfig(save_results=False),
            )
            sim = JSimulation(cfg, engine=engine)
            votes = []
            close = sim._advance_and_record

            def record(round_num, agent_votes, _close=close, _votes=votes):
                _votes.append([round_num, dict(agent_votes)])
                return _close(round_num, agent_votes)

            sim._advance_and_record = record
            stats = sim.run()
            decisions = [[r.round_num, dict(r.agent_values)] for r in sim.game.rounds]
            res["game"] = json.loads(json.dumps(
                dict(stats=stats, decisions=decisions, votes=votes,
                     reason=sim.game.termination_reason, failed=engine.failed_rows),
                sort_keys=True, default=str))
            sim.close()
        engine.shutdown()
        out[arm["name"]] = res
    return out


@pytest.mark.parametrize("arm", ARMS, ids=[a["name"] for a in ARMS])
def test_greedy_outputs_token_identical_to_jax_on_every_rank(ranks, jax_engines, one_rank, arm):
    """Under tp and dp the one-rank engine's outputs too; under sp the JAX
    engine's own sp outputs may part from its one-device ones at a near
    tie (C-port-8), and the port's follow the JAX sp engine."""
    want = (jax_engines[arm["name"]]["results"] if arm in JAX_ARMS
            else one_rank[arm["model"]]["results"])
    if arm["sp"] == 1:
        assert one_rank[arm["model"]]["results"] == want
    for res in ranks[arm["name"]]:
        assert json.loads(str(res["results"])) == want
    for row, prompt in zip(want, PROMPTS):
        assert set(row) == set(prompt[2]["required"])


@pytest.mark.parametrize("arm", GAME_ARMS, ids=[a["name"] for a in GAME_ARMS])
def test_game_equals_jax_on_the_same_mesh(ranks, jax_engines, arm):
    want = jax_engines[arm["name"]]["game"]
    assert len(want["stats"]) > 40 and len(want["decisions"]) == 1
    for res in ranks[arm["name"]]:
        assert json.loads(str(res["game"])) == want
