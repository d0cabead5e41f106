"""The fused mega-round of the PyTorch port (ROADMAP A10) against the JAX
package's.

* **Copy.** ``engine/megaround.py`` equals its original (``bcg_tpu.``
  read as ``bcg_tpu_torch.``) outside the module docstring and
  ``build_round_program``, the eager torch program.
* **Plan.** ``build_plan`` on the byte tokenizer gives both packages the
  same token buffers, masks, slot columns, slot tables and digit tables
  for the ``tiny-test`` and the ``bench-8b`` chat templates; at
  bench-8b's 10 agents, range 0-50 and 20 rounds, the windows the card
  runs (decide 512 / 478 real / 195 static prefix, vote 512 / 500 / 173).
* **Ops.** ``walk_token_dfa``, ``parse_int_values``,
  ``masked_exchange(_matrix)``, ``equivocate_proposals`` (with and
  without equivocators), ``tally_votes_dense`` and
  ``check_consensus_dense`` equal the JAX package's exactly on seeded
  numpy inputs.
* **Engine.** ``TorchEngine.run_megaround`` equals
  ``JaxEngine.run_megaround`` — all outputs and the decode steps — over
  3 rounds of carried state, over the bf16 and the int8 dense cache
  (greedy ``tiny-test``, f32 weights from ``PRNGKey(11)``, which give
  varied proposals).  Fused against lockstep (``batch_generate_json`` at
  temperature 0 over the same template prompts, each phase's budget):
  0 decision and 0 vote mismatches over 3 rounds.  A fresh engine makes
  one counted host sync a fused round (the ``round_readback`` seam, no
  ``done_poll``), round 1 included, and adds no compile record after
  round 1.
* **Game.** A fused 2 honest + 1 Byzantine game through both packages'
  ``BCGSimulation`` (three rounds, split votes) gives the same
  decisions, votes, termination, statistics and message totals; so do
  fused fake-engine games, and the fake engines' fused rounds.
* **The JAX package's own cases** (``tests/test_megaround.py``):
  template rendering, plan keys, the fake-engine mirror, and the
  orchestrator's dispatch with its warn-once lockstep fallback for every
  configuration that cannot fuse (free text, sequential dispatch, a lossy
  channel, a negative value range), plus the paged engine's refusal.
"""

import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.engine import megaround as jm
from bcg_tpu.engine.chat_template import format_chat_parts as j_chat_parts
from bcg_tpu.engine.fake import FakeEngine as JFakeEngine
from bcg_tpu.engine.jax_engine import JaxEngine, _LEN_BUCKETS as J_LEN_BUCKETS
from bcg_tpu.engine.tokenizer import tokenizer_for_model as j_tokenizer_for_model
from bcg_tpu.guided import token_dfa as j_dfa
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.parallel import game_step as j_gs
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.config import BCGConfig, EngineConfig, GameConfig, MetricsConfig
from bcg_tpu_torch.engine.chat_template import format_chat_parts as t_chat_parts
from bcg_tpu_torch.engine.fake import FakeEngine
from bcg_tpu_torch.engine.megaround import (
    MegaroundTemplate,
    MegaroundUnsupported,
    build_plan,
    decision_schema,
    vote_schema,
)
from bcg_tpu_torch.engine.tokenizer import ByteTokenizer, tokenizer_for_model
from bcg_tpu_torch.engine.torch_engine import TorchEngine, _LEN_BUCKETS
from bcg_tpu_torch.guided import token_dfa as t_dfa
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.obs import compile as obs_compile
from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.obs import hostsync as obs_hostsync
from bcg_tpu_torch.parallel import game_step as t_gs
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation
import _torch_jax_obs_state
from test_torch_serve import _LINT_IGNORE, _parts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "bcg-tpu/tiny-test"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers on one machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


# ------------------------------------------------------------------ copy

def test_megaround_module_equals_the_jax_one():
    names = ("__doc__", "build_round_program")
    orig = open(os.path.join(ROOT, "bcg_tpu", "engine", "megaround.py"), encoding="utf-8").read()
    port = open(os.path.join(ROOT, "bcg_tpu_torch", "engine", "megaround.py"),
                encoding="utf-8").read()
    orig = _LINT_IGNORE.sub("", orig.replace("bcg_tpu.", "bcg_tpu_torch."))
    orig_rest, orig_cut = _parts(orig, names)
    port_rest, port_cut = _parts(_LINT_IGNORE.sub("", port), names)
    assert port_rest == orig_rest
    assert set(orig_cut) == set(port_cut) == set(names)
    assert "jax" not in port_cut["build_round_program"]


# ------------------------------------------------------------------ plan

def _plans(model, n, lo, hi, rounds, max_model_len=8192):
    template = dict(n_agents=n, lo=lo, hi=hi, max_rounds=rounds)
    jp = jm.build_plan(jm.MegaroundTemplate(**template), j_tokenizer_for_model(model),
                       lambda s, u: j_chat_parts(model, s, u, True), max_model_len,
                       J_LEN_BUCKETS)
    tp = build_plan(MegaroundTemplate(**template), tokenizer_for_model(model),
                    lambda s, u: t_chat_parts(model, s, u, True), max_model_len,
                    _LEN_BUCKETS)
    return jp, tp


@pytest.mark.parametrize("model, n, hi, rounds", [
    ("bcg-tpu/tiny-test", 4, 50, 6), ("bcg-tpu/tiny-test", 3, 100, 10),
    ("bcg-tpu/bench-8b", 10, 50, 20),
])
def test_plan_equals_the_jax_plan(model, n, hi, rounds):
    jp, tp = _plans(model, n, 0, hi, rounds)
    assert tp.static_key() == jp.static_key()
    for name in ("val_table", "round_table", "digit_len", "digit_val"):
        assert np.array_equal(getattr(tp, name), getattr(jp, name)), name
    for phase in ("decide", "vote"):
        a, b = getattr(tp, phase), getattr(jp, phase)
        assert np.array_equal(a.base, b.base) and np.array_equal(a.valid, b.valid)
        assert (a.L, a.prompt_len, a.inbox_cols, a.own_col, a.round_col, a.max_new,
                a.prefix_len, a.schema) == (b.L, b.prompt_len, b.inbox_cols, b.own_col,
                                            b.round_col, b.max_new, b.prefix_len, b.schema)


def test_bench_8b_windows_are_the_cards():
    """The fused round's shapes on the card (P12): one 512-token window a
    phase, an 18-token budget, a static prefix prefilled once."""
    _, plan = _plans("bcg-tpu/bench-8b", 10, 0, 50, 20)
    got = [(p.L, p.prompt_len, p.prefix_len, p.max_new) for p in (plan.decide, plan.vote)]
    assert got == [(512, 478, 195, 18), (512, 500, 173, 18)]


# ------------------------------------------------------------------- ops

def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("seed", range(4))
def test_dfa_walk_and_integer_parse_equal_jax(seed):
    rng = np.random.default_rng(seed)
    U, S, V, B, T, eos = 2, 6, 24, 9, 12, 23
    tables = rng.integers(-1, S, size=(U, S, V)).astype(np.int32)
    tables[:, :, rng.integers(0, V, 4)] = rng.integers(0, S, size=(U, S, 4))
    accepting = rng.random((U, S)) < 0.5
    dfa_ids = rng.integers(0, U, B).astype(np.int32)
    init = rng.integers(0, S, B).astype(np.int32)
    out = rng.integers(0, V, size=(B, T)).astype(np.int32)
    for b in range(B):                      # EOS-filled past a random end
        out[b, rng.integers(1, T + 1):] = eos
    digit_len = np.where(rng.random(V) < 0.6, rng.integers(1, 3, V), 0).astype(np.int32)
    digit_val = (rng.integers(0, 10, V) * np.where(digit_len == 2, 11, 1)).astype(np.int32)
    j_final = np.asarray(j_dfa.walk_token_dfa(jnp.asarray(tables), jnp.asarray(dfa_ids),
                                              jnp.asarray(init), jnp.asarray(out), eos))
    t_final = t_dfa.walk_token_dfa(_t(tables), _t(dfa_ids), _t(init), _t(out), eos)
    assert t_final.dtype == torch.int32
    assert np.array_equal(t_final.numpy(), j_final)
    assert (j_final == -1).any() and (j_final >= 0).any()
    j_parsed = np.asarray(j_dfa.parse_int_values(jnp.asarray(out), eos, digit_len, digit_val,
                                                 jnp.asarray(j_final), accepting,
                                                 jnp.asarray(dfa_ids)))
    t_parsed = t_dfa.parse_int_values(_t(out), eos, digit_len, digit_val, t_final,
                                      _t(accepting), _t(dfa_ids))
    assert t_parsed.dtype == torch.int32
    assert np.array_equal(t_parsed.numpy(), j_parsed)


def test_digit_tables_equal_jax():
    tb = ByteTokenizer().token_bytes() + [b"", b"12", b"4a", b"007"]
    for a, b in zip(t_dfa.digit_token_tables(tb), j_dfa.digit_token_tables(tb)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_exchange_tally_and_consensus_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n, lo, hi = 7, 0, 50
    values = np.where(rng.random(n) < 0.2, -1, rng.integers(lo, hi + 1, n)).astype(np.int32)
    if seed == 0:
        values[:] = 7                       # every honest agent agrees
    mask = rng.random((n, n)) < 0.7
    np.fill_diagonal(mask, False)
    byz = rng.random(n) < 0.3
    initials = np.where(byz, -1, rng.integers(lo, hi + 1, n)).astype(np.int32)
    initials[0] = 7
    byz[0] = False
    for equiv in (np.zeros(n, bool), byz):
        jmat = np.asarray(j_gs.equivocate_proposals(jnp.asarray(values), jnp.asarray(equiv),
                                                    lo, hi))
        tmat = t_gs.equivocate_proposals(_t(values), _t(equiv), lo, hi)
        assert np.array_equal(tmat.numpy(), jmat)
        for j, t in zip(j_gs.masked_exchange_matrix(jnp.asarray(jmat), jnp.asarray(mask)),
                        t_gs.masked_exchange_matrix(tmat, _t(mask))):
            assert np.array_equal(t.numpy(), np.asarray(j))
    for j, t in zip(j_gs.masked_exchange(jnp.asarray(values), jnp.asarray(mask)),
                    t_gs.masked_exchange(_t(values), _t(mask))):
        assert np.array_equal(t.numpy(), np.asarray(j))
    votes = rng.integers(-1, 2, n).astype(np.int32)
    jt_, tt_ = j_gs.tally_votes_dense(jnp.asarray(votes)), t_gs.tally_votes_dense(_t(votes))
    assert set(jt_) == set(tt_)
    for k in jt_:
        assert tt_[k].item() == np.asarray(jt_[k]).item(), k
    jc = j_gs.check_consensus_dense(jnp.asarray(values), jnp.asarray(byz), jnp.asarray(initials))
    tc = t_gs.check_consensus_dense(_t(values), _t(byz), _t(initials))
    assert set(jc) == set(tc)
    for k in jc:
        assert tc[k].item() == np.asarray(jc[k]).item(), k
    if seed == 0:
        assert tc["has_consensus"].item() and tc["consensus_value"].item() == 7


# ---------------------------------------------------------------- engine

def named_arrays(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", a) for i, l in enumerate(v) for n, a in l.items()]
        else:
            out.append((k, v))
    return [(n, np.asarray(a)) for n, a in out]


def _weights(seed):
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(seed), dtype=jnp.float32)
    return jp, params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)


@pytest.fixture(scope="module")
def weights():
    return _weights(11)


def _engine_cfg(C, backend, **kw):
    return C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048, **kw)


@pytest.fixture(scope="module", params=["bfloat16", "int8"])
def engines(request, weights):
    jp, tp = weights
    je = JaxEngine(_engine_cfg(jcfg, "jax", kv_cache_dtype=request.param), params=jp)
    te = TorchEngine(_engine_cfg(tcfg, "torch", kv_cache_dtype=request.param), device="cpu",
                     params=tp)
    yield je, te
    je.shutdown()
    te.shutdown()


N = 4
MASK = ~np.eye(N, dtype=bool)
BYZ = np.array([False, False, False, True])
START = np.array([3, 17, 3, 42], np.int32)
RESULT_FIELDS = ("proposed", "values", "received", "deliveries", "vote_raw", "votes", "stop",
                 "cont", "terminate", "has_consensus", "consensus_value", "agreement_pct")


def _rounds(engine, plan, equivocate=(None, BYZ, None)):
    """Three fused rounds of carried state; each round's result and the
    engine's decode steps."""
    values, inbox = START, np.full((N, N), -1, np.int32)
    out = []
    for r, equiv in enumerate(equivocate, 1):
        res = engine.run_megaround(plan, values, inbox, r, MASK, BYZ, START,
                                   equivocators=equiv)
        out.append((res, engine.last_decode_steps))
        values, inbox = res.values, res.received
    return out


def test_fused_rounds_equal_jax(engines):
    je, te = engines
    jplan = je.prepare_megaround(n_agents=N, lo=0, hi=50, max_rounds=6)
    tplan = te.prepare_megaround(n_agents=N, lo=0, hi=50, max_rounds=6)
    got, want = _rounds(te, tplan), _rounds(je, jplan)
    for (tr, ts), (jr, js) in zip(got, want):
        assert ts == js
        for f in RESULT_FIELDS:
            assert np.array_equal(np.asarray(getattr(tr, f)), np.asarray(getattr(jr, f))), f
        assert tr.received.dtype == np.int32 and tr.received.shape == (N, N)
    proposals = {v for r, _ in got for v in r.proposed.tolist()}
    assert len(proposals) > 2, proposals
    assert te.megaround_stats()["fused_rounds"] == 3


def _parse(row, lo, hi):
    if not isinstance(row, dict) or "error" in row:
        return -1
    v = row.get("value")
    if isinstance(v, bool) or not isinstance(v, int):
        return -1
    return v if lo <= v <= hi else -1


def test_fused_rounds_equal_the_lockstep_oracle(engines):
    """The perf gate's oracle arm: each fused round's proposals and votes
    equal ``batch_generate_json`` at temperature 0 over the same rendered
    template prompts with each phase's budget."""
    _, te = engines
    plan = te.prepare_megaround(n_agents=N, lo=0, hi=50, max_rounds=6)
    values, inbox = START, np.full((N, N), -1, np.int32)
    mismatches = [0, 0]
    for r in (1, 2, 3):
        res = te.run_megaround(plan, values, inbox, r, MASK, BYZ, START)
        dec = te.batch_generate_json(plan.template.decision_prompts(values, inbox, r),
                                     temperature=0.0, max_tokens=plan.decide.max_new)
        vote = te.batch_generate_json(plan.template.vote_prompts(res.values, res.received, r),
                                      temperature=0.0, max_tokens=plan.vote.max_new)
        mismatches[0] += int((np.asarray([_parse(d, 0, 50) for d in dec]) != res.proposed).sum())
        mismatches[1] += int((np.asarray([1 if _parse(v, 0, 1) == 1 else 0 for v in vote])
                              != res.votes).sum())
        values, inbox = res.values, res.received
    assert mismatches == [0, 0]


def test_one_host_sync_and_no_compile_record_after_round_one(weights, monkeypatch):
    """A fresh engine's fused rounds under ``BCG_TPU_HOSTSYNC`` and
    ``BCG_TPU_COMPILE_OBS``: one counted sync a round, at the
    ``round_readback`` seam (round 1's plan setup included), no
    ``done_poll``; the compile records all come in round 1."""
    monkeypatch.setenv("BCG_TPU_HOSTSYNC", "1")
    monkeypatch.setenv("BCG_TPU_COMPILE_OBS", "1")
    obs_hostsync.reset()
    obs_compile.reset()
    try:
        te = TorchEngine(_engine_cfg(tcfg, "torch"), device="cpu", params=weights[1])
        plan = te.prepare_megaround(n_agents=N, lo=0, hi=50, max_rounds=6)
        names = ("engine.hostsync.total", "engine.hostsync.site.round_readback",
                 "engine.hostsync.site.done_poll", "engine.compile_obs.cache_entries")
        values, inbox = START, np.full((N, N), -1, np.int32)
        seen = []
        for r in (1, 2, 3):
            before = [obs_counters.value(k) for k in names]
            res = te.run_megaround(plan, values, inbox, r, MASK, BYZ, START)
            seen.append([obs_counters.value(k) - b for k, b in zip(names, before)])
            values, inbox = res.values, res.received
        assert [s[:3] for s in seen] == [[1, 1, 0]] * 3
        assert seen[0][3] > 0 and seen[1][3] == seen[2][3] == 0
        te.shutdown()
    finally:
        monkeypatch.delenv("BCG_TPU_HOSTSYNC")
        monkeypatch.delenv("BCG_TPU_COMPILE_OBS")
        obs_hostsync.reset()
        obs_compile.reset()


# ------------------------------------------------------------------ game

def _game_config(C, backend, **engine_kw):
    cfg = C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=3, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048,
                              **engine_kw),
        metrics=C.MetricsConfig(save_results=False),
    )
    return dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, megaround=True))


def _play(sim):
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        stats = sim.run()
    decisions = [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds]
    messages = sim.network.protocol.get_total_message_count() + sim._spmd_message_count
    return stats, decisions, votes, messages, sim.game.termination_reason


def test_fused_game_equals_the_jax_fused_game():
    """Weights from ``PRNGKey(25)``: the votes split, so the game plays
    all three rounds on carried inboxes."""
    jp, tp = _weights(25)
    je = JaxEngine(_engine_cfg(jcfg, "jax"), params=jp)
    te = TorchEngine(_engine_cfg(tcfg, "torch"), device="cpu", params=tp)
    jsim = JSimulation(_game_config(jcfg, "jax"), engine=je)
    tsim = BCGSimulation(_game_config(tcfg, "torch"), engine=te)
    got, want = _play(tsim), _play(jsim)
    je.shutdown()
    te.shutdown()
    assert got == want
    stats = got[0]
    assert tsim._megaround_rounds == stats["total_rounds"] == 3
    assert {v for _, votes in got[2] for v in votes.values()} == {True, False}
    assert len(stats) > 40 and got[3] > 0


@pytest.mark.parametrize("strategy", [None, "equivocate"])
def test_fused_fake_game_equals_the_jax_one(strategy):
    def config(C):
        cfg = _game_config(C, "fake")
        return dataclasses.replace(cfg, game=dataclasses.replace(
            cfg.game, num_honest=5, num_byzantine=2, max_rounds=6,
            byzantine_strategy=strategy))

    jsim, tsim = JSimulation(config(jcfg)), BCGSimulation(config(tcfg))
    got, want = _play(tsim), _play(jsim)
    assert got == want
    assert tsim.engine.megaround_rounds == got[0]["total_rounds"]


def test_fake_fused_round_equals_the_jax_one():
    rng = np.random.default_rng(2)
    n = 6
    for policy in ("consensus", "mixed:consensus:equivocate"):
        je, te = JFakeEngine(policy=policy), FakeEngine(policy=policy)
        jplan = je.prepare_megaround(n_agents=n, lo=0, hi=50, max_rounds=6)
        tplan = te.prepare_megaround(n_agents=n, lo=0, hi=50, max_rounds=6)
        values = rng.integers(0, 51, n).astype(np.int32)
        inbox = np.where(rng.random((n, n)) < 0.5, -1, rng.integers(0, 51, (n, n)))
        mask = rng.random((n, n)) < 0.8
        byz = np.arange(n) >= n - 2
        args = (values, inbox.astype(np.int32), 2, mask, byz, values)
        jr = je.run_megaround(jplan, *args, equivocators=byz)
        tr = te.run_megaround(tplan, *args, equivocators=byz)
        for f in RESULT_FIELDS:
            assert np.array_equal(np.asarray(getattr(tr, f)), np.asarray(getattr(jr, f))), f


# ------------------------------------------- the JAX package's own cases

_LADDER = (256, 384, 512, 768, 1024)


def _chat_parts(system: str, user: str):
    # A minimal chat template: the plan builder needs (prefix, suffix)
    # whose concatenation embeds the user prompt exactly once, like the
    # real model templates the engine binds.
    return (f"<s>[SYS]{system}[/SYS]\n{user}", "\n[END]")


def _tiny_plan(n=4, lo=0, hi=50, max_rounds=6):
    template = MegaroundTemplate(n_agents=n, lo=lo, hi=hi, max_rounds=max_rounds)
    return build_plan(template, ByteTokenizer(), _chat_parts, 2048, _LADDER)


class TestTemplate:
    def test_fixed_width_rendering(self):
        """Every (values, inbox, round) combination renders to the SAME
        byte length — the property that lets slots become static token
        columns."""
        t = MegaroundTemplate(n_agents=4, lo=0, hi=50, max_rounds=9)
        lengths = set()
        for values, round_num in [([3, 17, 3, 42], 1), ([50, 0, 7, 9], 9),
                                  ([-1, -1, -1, -1], 0)]:
            vals = np.asarray(values, np.int32)
            inbox = np.tile(vals, (4, 1))
            for _sys, user, _schema in t.decision_prompts(vals, inbox, round_num):
                lengths.add(len(user.encode("utf-8")))
            for _sys, user, _schema in t.vote_prompts(vals, inbox, round_num):
                lengths.add(len(user.encode("utf-8")))
        # One length per phase (tails differ), not per round state.
        assert len(lengths) == 2, lengths

    def test_slot_lines_feed_fake_engine_policies(self):
        """The rendered lines match the fake engine's stock prompt regexes
        (present slots parse, dash slots fail)."""
        from bcg_tpu_torch.engine.fake import _CURRENT_RE, _ROUND_RE, _VALUE_RE

        t = MegaroundTemplate(n_agents=3, lo=0, hi=50, max_rounds=6)
        vals = np.asarray([7, -1, 23], np.int32)
        inbox = np.asarray([[-1, -1, 23], [7, -1, 23], [7, -1, -1]], np.int32)
        _sys, user, _schema = t.decision_prompts(vals, inbox, 2)[0]
        assert [int(v) for v in _VALUE_RE.findall(user)] == [23]
        assert int(_CURRENT_RE.search(user).group(1)) == 7
        assert int(_ROUND_RE.search(user).group(1)) == 2
        _sys2, user2, _schema2 = t.decision_prompts(vals, inbox, 2)[1]
        assert _CURRENT_RE.search(user2) is None

    def test_schemas(self):
        d = decision_schema(0, 50)
        assert d["properties"]["value"]["minimum"] == 0
        assert d["properties"]["value"]["maximum"] == 50
        assert vote_schema()["properties"]["value"]["maximum"] == 1


class TestPlan:
    def test_static_key_is_round_state_free(self):
        k1, k2 = _tiny_plan().static_key(), _tiny_plan().static_key()
        assert k1 == k2 and hash(k1) == hash(k2)

    def test_layout_change_changes_key(self):
        assert _tiny_plan(n=4).static_key() != _tiny_plan(n=5).static_key()

    def test_prefix_precedes_every_dynamic_slot(self):
        plan = _tiny_plan()
        for phase in (plan.decide, plan.vote):
            dynamic = (phase.round_col, phase.own_col) + phase.inbox_cols
            assert all(col >= phase.prefix_len for col in dynamic)
            assert 0 < phase.prefix_len < phase.L

    def test_negative_range_unsupported(self):
        template = MegaroundTemplate(n_agents=4, lo=-5, hi=5, max_rounds=6)
        with pytest.raises(MegaroundUnsupported, match="negative"):
            build_plan(template, ByteTokenizer(), _chat_parts, 2048, _LADDER)


class TestFakeEngineMirror:
    def test_prepare_mirrors_range_gate(self):
        with pytest.raises(MegaroundUnsupported):
            FakeEngine().prepare_megaround(n_agents=4, lo=-1, hi=5, max_rounds=6)

    def test_fused_round_exchange_and_tally(self):
        eng = FakeEngine(policy="consensus")
        plan = eng.prepare_megaround(n_agents=4, lo=0, hi=50, max_rounds=6)
        values = np.asarray([7, 7, 7, 7], np.int32)
        mask = ~np.eye(4, dtype=bool)
        res = eng.run_megaround(plan, values, np.tile(values, (4, 1)), 2, mask,
                                np.zeros(4, bool), values)
        assert list(res.proposed) == [7, 7, 7, 7]
        received, deliveries = t_gs.masked_exchange(_t(res.proposed), _t(mask))
        np.testing.assert_array_equal(res.received, received.numpy())
        np.testing.assert_array_equal(res.deliveries, deliveries.numpy())
        assert res.terminate and res.has_consensus
        assert res.consensus_value == 7 and res.agreement_pct == 100.0
        assert res.vote_dict(["a", "b", "c", "d"]) == dict.fromkeys("abcd", True)

    def test_sync_profile_matches_fused_entry(self):
        eng = FakeEngine()
        plan = eng.prepare_megaround(n_agents=3, lo=0, hi=50, max_rounds=6)
        values = np.asarray([3, 17, 42], np.int32)
        eng.run_megaround(plan, values, np.full((3, 3), -1, np.int32), 1,
                          ~np.eye(3, dtype=bool), np.zeros(3, bool), values)
        stats = eng.megaround_stats()
        assert stats["fused_rounds"] == 1
        assert stats["syncs_per_round"] == 1.0
        assert stats["rounds_per_sec"] > 0


def _sim_config(**agent_kw):
    cfg = BCGConfig(
        game=GameConfig(num_honest=3, num_byzantine=1, max_rounds=6, seed=0),
        engine=EngineConfig(backend="fake", model_name=MODEL),
        metrics=MetricsConfig(save_results=False),
    )
    return dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, **agent_kw))


class TestOrchestratorDispatch:
    def test_fused_game_converges(self):
        sim = BCGSimulation(config=_sim_config(megaround=True))
        stats = sim.run()
        assert stats["consensus_outcome"] == "valid"
        assert sim.engine.megaround_rounds == stats["total_rounds"]
        assert sim.engine.megaround_stats()["syncs_per_round"] == 1.0

    def test_env_flag_turns_the_fused_round_on(self, monkeypatch):
        monkeypatch.setenv("BCG_TPU_MEGAROUND", "1")
        sim = BCGSimulation(config=_sim_config(megaround=False))
        stats = sim.run()
        assert sim.engine.megaround_rounds == stats["total_rounds"] >= 1

    def test_flag_off_stays_lockstep(self, monkeypatch):
        monkeypatch.delenv("BCG_TPU_MEGAROUND", raising=False)
        sim = BCGSimulation(config=_sim_config(megaround=False))
        stats = sim.run()
        assert stats["consensus_outcome"] == "valid"
        assert sim.engine.megaround_rounds == 0

    @pytest.mark.parametrize("break_it", ["structured", "batched", "protocol", "range"],
                             ids=["free-text", "sequential", "lossy-channel",
                                  "negative-range"])
    def test_unsupported_configs_fall_back_with_warning(self, break_it):
        """The fallback matrix: any ineligible configuration plays the
        full lockstep game and says so ONCE."""
        cfg = _sim_config(megaround=True)
        if break_it == "structured":
            cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
                cfg.agent, use_structured_output=False))
        elif break_it == "batched":
            cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
                cfg.agent, use_batched_inference=False))
        elif break_it == "protocol":
            cfg = dataclasses.replace(cfg, communication=dataclasses.replace(
                cfg.communication, protocol_type="lossy_sim"))
        else:
            cfg = dataclasses.replace(cfg, game=dataclasses.replace(
                cfg.game, value_range=(-5, 5)))
        sim = BCGSimulation(config=cfg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            stats = sim.run()
        mega = [w for w in caught if issubclass(w.category, RuntimeWarning)
                and "megaround" in str(w.message)]
        assert len(mega) == 1, [str(w.message) for w in caught]
        assert sim.engine.megaround_rounds == 0
        assert stats["total_rounds"] >= 1

    def test_paged_engine_refuses_the_fused_round(self, weights):
        te = TorchEngine(_engine_cfg(tcfg, "torch", paged_kv=True), device="cpu",
                         params=weights[1])
        with pytest.raises(MegaroundUnsupported, match="paged"):
            te.prepare_megaround(n_agents=3, lo=0, hi=50, max_rounds=4)
        te.shutdown()
