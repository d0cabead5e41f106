"""Fast-forward and speculative decoding in the PyTorch port, against the
JAX package and against the port's own plain loop.

* **Op.** The plain version of the bf16 chunk decode kernel matches the
  Pallas ``_decode_kernel`` chunk form run in interpret mode (as the JAX
  package's own tests run it) at 1e-5 in f32 and 2e-2 in bf16, with a
  group-5 case and a fully masked row.  The drafter (``draft_tokens``)
  and the acceptance test (``accept_draft``, handed the JAX draw's
  uniforms) give the JAX package's results exactly; the forced-chain
  tables are equal.
* **Model.** ``decode_chunk`` (a shared write slot, as a Python int and
  as a device tensor) and ``decode_chunk_spec`` (per-row slots) over the
  bf16 cache give the JAX package's logits at the ROADMAP C-port-1
  decode tolerance.
* **Engine.** Greedy output is token-identical per row to ``JaxEngine``
  with ``decode_fast_forward`` and with ``spec_decode`` (decision and
  vote schemas, two-level prefixes, a padded batch, the free path), with
  the same decode-step counts and draft counts; and the port's
  fast-forward and speculative loops match its own plain loop in fewer
  steps, as ``tests/test_fast_forward.py`` and
  ``tests/test_speculative.py`` hold the JAX loops.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.engine import speculative as jspec
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.guided import processor as jproc
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.obs import counters as obs_counters
from bcg_tpu.ops import decode_attention as jda
from bcg_tpu_torch.engine import speculative as tspec
from bcg_tpu_torch.engine.torch_engine import TorchEngine, _ff_decode_slots
from bcg_tpu_torch.guided import processor as tproc
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.ops import decode_attention as tda
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


TOL = {False: 1e-5, True: 2e-2}
DECODE_TOL_F32 = 1e-2     # ROADMAP C-port-1: decode logits read the bf16 cache
MODEL = "bcg-tpu/tiny-test"

VOTE = {
    "type": "object",
    "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
    "required": ["decision"],
    "additionalProperties": False,
}
DECISION = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 30},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
        "public_reasoning": {"type": "string", "minLength": 1, "maxLength": 30},
    },
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False,
}
TOKEN_BYTES = [bytes([i]) for i in range(256)]


def named_arrays(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", np.asarray(a)) for i, l in enumerate(v)
                    for n, a in l.items()]
        else:
            out.append((k, np.asarray(v)))
    return out


# ------------------------------------------------------------------- op

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,K", [(4, 2, 4), (8, 2, 4), (8, 2, 5), (10, 2, 5)],
                         ids=["g2-ff", "g4-ff", "g4-spec", "g5-spec"])
def test_chunk_plain_matches_pallas_kernel(H, Hkv, K, bf16):
    rng = np.random.default_rng([H, Hkv, K, int(bf16), 1])
    B, S, Dh = 2, 300, 128                       # ragged S: the JAX wrapper pads it
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in [(B, K, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)])
    m = rng.random((B, K, S)) < 0.5
    m[1, 3] = False                              # a fully masked chunk row gives 0
    j = [jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x) for x in (q, k, v)]
    t = [torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
         for x in (q, k, v)]
    scale = Dh ** -0.5
    ref = jda.chunk_decode_attention(*j, jnp.asarray(m), scale, block_s=128, interpret=True)
    before = tda.chunk_decode_attention.launches
    out = tda.chunk_decode_attention(*t, torch.from_numpy(m), scale)
    assert tda.chunk_decode_attention.launches == before   # CPU: the plain version
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[bf16], rtol=TOL[bf16])
    assert np.all(out[1, 3].float().numpy() == 0.0)


@pytest.mark.parametrize("schema", [VOTE, DECISION], ids=["vote", "decision"])
def test_forced_chain_tables_equal_jax(schema):
    jg = jproc.compile_schema(schema, TOKEN_BYTES, vocab_id=901, compact=True)
    tg = tproc.compile_schema(schema, TOKEN_BYTES, vocab_id=901, compact=True)
    td = tg.token_dfa
    for a, b in zip(tproc._forced_chains(td.transitions, td.accepting),
                    jproc._forced_chains(jg.token_dfa.transitions, jg.token_dfa.accepting)):
        assert np.array_equal(a, b)
    assert tproc.FF_CHUNK == jproc.FF_CHUNK
    jb, tb = jproc.GuidedBatch([jg, jg]), tproc.GuidedBatch([tg, tg])
    for name in ("chain_tok", "chain_len", "chain_next"):
        assert np.array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name))), name
    perm = tproc.GuidedBatch.permissive(3, 300)
    assert perm.chain_tok.shape == (1, 1, tproc.FF_CHUNK - 1) and int(perm.chain_len.sum()) == 0


def _draft_inputs(rng, B, V, guided):
    """Histories with repeats (matches), a batch of tokens and states."""
    H = 72
    hist = np.full((B, H), -1, np.int32)
    cur0 = rng.integers(2, 60, B).astype(np.int32)
    for i in range(B):
        hist[i, :cur0[i]] = rng.integers(0, 3 if not guided else V, cur0[i])
    tok = rng.integers(0, 3, B).astype(np.int32)
    return hist, cur0, tok


@pytest.mark.parametrize("guided", [False, True], ids=["permissive", "vote-dfa"])
def test_draft_tokens_equal_jax(guided):
    rng = np.random.default_rng(int(guided))
    B, k, n = 12, 4, 3
    if guided:
        tg = tproc.compile_schema(VOTE, TOKEN_BYTES, vocab_id=902)
        jg = jproc.compile_schema(VOTE, TOKEN_BYTES, vocab_id=902)
        tb, jb = tproc.GuidedBatch([tg] * B), jproc.GuidedBatch([jg] * B)
        states = rng.integers(0, tg.token_dfa.num_states, B).astype(np.int32)
        eos = 0
    else:
        tb, jb = tproc.GuidedBatch.permissive(B, 64), jproc.GuidedBatch.permissive(B, 64)
        states = np.zeros(B, np.int32)
        eos = 63
    V = tb.min_budget.shape[-1]
    hist, cur0, tok = _draft_inputs(rng, B, V, guided)
    if guided:   # echo a legal vote so the n-gram source fires on the DFA
        row = [ord(c) for c in '{"decision": "stop"}{"decision": "st']
        hist[0, :len(row)] = row
        cur0[0] = len(row)
    done = rng.random(B) < 0.2
    emitted = rng.integers(0, 10, B).astype(np.int32)
    budget = rng.integers(8, 40, B).astype(np.int32)
    jout = jspec.draft_tokens(
        jnp.asarray(hist), jnp.asarray(cur0), jnp.asarray(tok), jnp.asarray(states),
        jnp.asarray(done), jb.tables, jb.min_budget, jb.chain_tok, jb.chain_len, jb.dfa_ids,
        jnp.asarray(emitted), jnp.asarray(budget), k=k, n=n, eos_id=eos)
    tout = tspec.draft_tokens(
        torch.from_numpy(hist), torch.from_numpy(cur0), torch.from_numpy(tok),
        torch.from_numpy(states), torch.from_numpy(done), tb.tables, tb.min_budget,
        tb.chain_tok, tb.chain_len, tb.dfa_ids, torch.from_numpy(emitted),
        torch.from_numpy(budget), k=k, n=n, eos_id=eos)
    for a, b in zip(tout, jout):
        assert np.array_equal(a.numpy().astype(np.int64), np.asarray(b).astype(np.int64))
    assert tout[1].any()                         # some row drafted
    if not guided:   # the permissive automaton: the draft IS the numpy oracle's continuation
        d, dm = tout[0].numpy(), tout[1].numpy()
        for i in range(B):
            if done[i]:
                continue
            ref = tspec.ngram_draft_np(hist[i, :cur0[i]].tolist(), int(tok[i]), n, k)
            ref = ref[:max(0, min(k, budget[i] - emitted[i] - 1))]
            assert d[i][dm[i]].tolist() == ref


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_accept_draft_equal_jax(greedy):
    rng = np.random.default_rng(7 + int(greedy))
    B, K, V = 6, 4, 40
    la = (rng.standard_normal((B, K + 1, V)) * 2).astype(np.float32)
    draft = np.argmax(la[:, :K], axis=-1).astype(np.int32)
    draft[1, 2] = (draft[1, 2] + 1) % V         # a wrong draft truncates acceptance
    draft[3, 0] = (draft[3, 0] + 3) % V
    dmask = np.ones((B, K), bool)
    dmask[4, 2:] = False
    temps = np.zeros(B, np.float32) if greedy else np.full(B, 0.8, np.float32)
    budget = np.full(B, 100, np.int32)
    jb, tb = jproc.GuidedBatch.permissive(B, V), tproc.GuidedBatch.permissive(B, V)
    key = jax.random.PRNGKey(3)
    jacc, jforbid, jnext, _ = jspec.accept_draft(
        jnp.asarray(la), jnp.asarray(draft), jnp.asarray(dmask), jnp.zeros((B, K), jnp.int32),
        jnp.zeros(B, jnp.int32), key, jb.tables, jb.accepting, jb.min_budget, jb.dfa_ids,
        jnp.asarray(temps), jnp.asarray(budget),
        masked_logits=jspec.make_masked_logits(V - 1, 1.0), eos_id=V - 1)
    # The uniforms the JAX acceptance drew, handed to the port.
    u = np.array(jax.random.uniform(jax.random.split(key)[1], (B, K)))
    tacc, tforbid, tnext = tspec.accept_draft(
        torch.from_numpy(la), torch.from_numpy(draft), torch.from_numpy(dmask),
        torch.zeros((B, K), dtype=torch.int32), torch.zeros(B, dtype=torch.int32), None,
        tb.tables, tb.accepting, tb.min_budget, tb.dfa_ids, torch.from_numpy(temps),
        torch.from_numpy(budget), masked_logits=tspec.make_masked_logits(V - 1, 1.0),
        u=torch.from_numpy(u))
    assert tacc.tolist() == np.asarray(jacc).tolist()
    assert tforbid.tolist() == np.asarray(jforbid).tolist()
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
    if greedy:
        assert tacc.tolist()[:5] == [4, 2, 4, 0, 2]


def test_numpy_oracles_and_slot_counts_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(20):
        h = rng.integers(0, 5, rng.integers(3, 40)).tolist()
        t = int(rng.integers(0, 5))
        assert tspec.ngram_draft_np(h, t, 3, 4) == jspec.ngram_draft_np(h, t, 3, 4)
        out = rng.integers(0, 5, 30).tolist()
        assert tspec.spec_mirror_np(h, out, 3, 4, eos_id=4) == \
            jspec.spec_mirror_np(h, out, 3, 4, eos_id=4)
    assert tspec.spec_decode_slots(100, 4) == jspec.spec_decode_slots(100, 4) == 106
    from bcg_tpu.engine.jax_engine import _ff_decode_slots as j_ff_slots

    assert _ff_decode_slots(64) == j_ff_slots(64) == 104


# ---------------------------------------------------------------- model

def _setup(seed):
    jspec_, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jt.init_params(jspec_, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32)
    return jspec_, spec, jp, tp


def test_decode_chunk_and_spec_chunk_match_jax():
    """A fast-forward chunk (shared slot: a Python int and a 0-d device
    tensor give the same logits and cache) and a speculative chunk
    (per-row slots, logits at every position) over the bf16 cache."""
    jspec_, spec, jp, tp = _setup(6)
    rng = np.random.RandomState(8)
    B, L, S, K, K1 = 3, 32, 64, 4, 5
    tokens = rng.randint(0, 256, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    valid[1, :9] = False
    valid[2, :20] = False
    jl, jc = jt.prefill(jp, jspec_, jnp.asarray(tokens), jnp.asarray(valid),
                        jt.init_kv_cache(jspec_, B, S))
    caches = []
    for wp_arg in (L, torch.tensor(L)):
        tc = tt.init_kv_cache(spec, B, S)
        tt.prefill(tp, spec, torch.from_numpy(tokens).long(), torch.from_numpy(valid), tc)
        caches.append((wp_arg, tc))
    vm = np.zeros((B, S), bool)
    vm[:, :L] = valid
    lens = valid.sum(1).astype(np.int32)
    chunk = rng.randint(0, 256, (B, K)).astype(np.int32)
    cvalid = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [1, 1, 1, 1]], bool)
    pos = lens[:, None] + np.arange(K)[None]
    jl, jc = jt.decode_chunk(jp, jspec_, jnp.asarray(chunk), jnp.asarray(cvalid),
                             jnp.int32(L), jnp.asarray(pos.astype(np.int32)), jc,
                             jnp.asarray(vm))
    outs = []
    for wp_arg, tc in caches:
        tl, _ = tt.decode_chunk(tp, spec, torch.from_numpy(chunk).long(),
                                torch.from_numpy(cvalid), wp_arg, torch.from_numpy(pos), tc,
                                torch.from_numpy(vm))
        _close(tl, jl)
        outs.append(tl)
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(caches[0][1].buf, caches[1][1].buf)
    tc = caches[0][1]
    vm[:, L:L + K] = cvalid
    rwp = L + K + np.array([1, 0, 2], np.int32)
    chunk = rng.randint(0, 256, (B, K1)).astype(np.int32)
    cvalid = np.array([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], bool)
    pos = (lens + K)[:, None] + np.arange(K1)[None]
    jl, jc = jt.decode_chunk_spec(jp, jspec_, jnp.asarray(chunk), jnp.asarray(cvalid),
                                  jnp.asarray(rwp), jnp.asarray(pos.astype(np.int32)), jc,
                                  jnp.asarray(vm))
    tl, tc = tt.decode_chunk_spec(tp, spec, torch.from_numpy(chunk).long(),
                                  torch.from_numpy(cvalid), torch.from_numpy(rwp),
                                  torch.from_numpy(pos), tc, torch.from_numpy(vm))
    assert tl.shape == (B, K1, spec.vocab_size)
    _close(tl, jl)
    # The cache at the chunks' real slots.
    real = vm.copy()
    for b in range(B):
        real[b, rwp[b]:rwp[b] + K1] |= cvalid[b]
    for li in range(spec.num_layers):
        _close(tc[li]["k"].float().numpy()[real], np.asarray(jc[li]["k"], np.float32)[real])


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=DECODE_TOL_F32, rtol=DECODE_TOL_F32)


# --------------------------------------------------------------- engine

PROMPTS = [
    (f"You are agent_{i}. Reach consensus.",
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION if i % 2 else VOTE)
    for i in range(5)
] + [("You are agent_9, a careful voter.", "Vote now.", VOTE)]
CORE = "Proposals: agent_0=12, agent_1=30, agent_2=12. History: none."


@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


def _engines(params, **loop):
    jp, tp = params
    je = JaxEngine(jcfg.EngineConfig(backend="jax", model_name=MODEL, max_model_len=2048,
                                     **loop), params=jp)
    te = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048,
                                       **loop), device="cpu", params=tp)
    return je, te


@pytest.mark.parametrize("loop", [dict(decode_fast_forward=True), dict(spec_decode=True)],
                         ids=["ff", "spec"])
def test_engine_greedy_identical_to_jax(params, loop):
    je, te = _engines(params, **loop)
    before = obs_counters.snapshot()
    a = je.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    moved = obs_counters.delta(before)
    b = te.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    assert b == a
    assert all("error" not in r for r in b)
    assert te.last_decode_steps == je.last_decode_steps
    if "spec_decode" in loop:
        assert te.spec_drafted == moved.get("engine.spec.drafted", 0) > 0
        assert te.spec_accepted == moved.get("engine.spec.accepted", 0) > 0
    # Two-level (core, tail) prefixes, padded from three rows to four,
    # with per-row budgets.
    two = [("You are a voter.", (CORE, f" You are agent_{i}. Vote."), VOTE) for i in range(3)]
    a = je.batch_generate_json(two, temperature=0.0, max_tokens=[24, 40, 32])
    b = te.batch_generate_json(two, temperature=0.0, max_tokens=[24, 40, 32])
    assert b == a
    assert te.last_decode_steps == je.last_decode_steps
    free = ["repeat after me: alpha beta gamma alpha beta", "the quick brown fox"]
    assert te.batch_generate(free, temperature=0.0, max_tokens=24) == \
        je.batch_generate(free, temperature=0.0, max_tokens=24)
    je.shutdown()
    te.shutdown()


@pytest.fixture(scope="module")
def own_engines(params):
    _, tp = params
    base = tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048)
    engines = {
        name: TorchEngine(dataclasses.replace(base, **kw), device="cpu", params=tp)
        for name, kw in (("plain", {}), ("ff", dict(decode_fast_forward=True)),
                         ("spec", dict(spec_decode=True)))
    }
    yield engines
    for e in engines.values():
        e.shutdown()


@pytest.mark.parametrize("loop", ["ff", "spec"])
def test_loop_matches_own_plain_loop_in_fewer_steps(own_engines, loop):
    """As ``tests/test_fast_forward.py:84-120`` and
    ``tests/test_speculative.py`` hold the JAX loops: identical greedy
    output to the plain loop on the decision and vote schemas, in fewer
    weight passes."""
    plain, other = own_engines["plain"], own_engines[loop]
    prompts = [("honest agent system prompt", "Round 3: propose a value", DECISION),
               ("byzantine agent system prompt", "Round 3: vote now", VOTE),
               ("honest agent system prompt", "Round 4: propose a value", DECISION)]
    r_plain = plain.batch_generate_json(prompts, temperature=0.0, max_tokens=80)
    n_plain = plain.last_decode_steps
    r_other = other.batch_generate_json(prompts, temperature=0.0, max_tokens=80)
    assert r_other == r_plain
    assert all("error" not in r for r in r_plain)
    assert other.last_decode_steps < n_plain, (other.last_decode_steps, n_plain)


@pytest.mark.parametrize("max_tokens", [24, 30, 40])
def test_fast_forward_tight_budgets_identical(own_engines, max_tokens):
    """Budgets barely above the vote's shortest completion: the
    compacted-write capacity guard may switch chains off late in the
    generation without changing the greedy output."""
    plain, ff = own_engines["plain"], own_engines["ff"]
    r_plain = plain.batch_generate_json([("s", "vote", VOTE)], temperature=0.0,
                                        max_tokens=max_tokens)
    n_plain = plain.last_decode_steps
    r_ff = ff.batch_generate_json([("s", "vote", VOTE)], temperature=0.0,
                                  max_tokens=max_tokens)
    assert r_ff == r_plain and "error" not in r_plain[0]
    assert ff.last_decode_steps < n_plain


def test_fast_forward_capacity_guard_degrades_safely(params, monkeypatch):
    """A tail of max_new + 2K slots makes the guard's bound i + 1, so
    chains die after the first iteration: the writes stay in bounds, the
    steps rise to about the plain loop's, the output is unchanged."""
    import bcg_tpu_torch.engine.torch_engine as te_mod

    _, tp = params
    base = tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048)
    plain = TorchEngine(base, device="cpu", params=tp)
    r_plain = plain.batch_generate_json([("s", "vote", VOTE)], temperature=0.0, max_tokens=40)
    n_plain = plain.last_decode_steps
    monkeypatch.setattr(te_mod, "_ff_decode_slots",
                        lambda max_new: max_new + 2 * tproc.FF_CHUNK)
    ff = TorchEngine(dataclasses.replace(base, decode_fast_forward=True), device="cpu",
                     params=tp)
    r_ff = ff.batch_generate_json([("s", "vote", VOTE)], temperature=0.0, max_tokens=40)
    assert r_ff == r_plain
    assert ff.last_decode_steps >= n_plain - tproc.FF_CHUNK


def test_sampled_rows_stay_schema_valid(own_engines):
    """Temperature > 0 under both loops (rejection sampling with the
    forbid residual in the speculative one): every row parses."""
    for name in ("ff", "spec"):
        eng = own_engines[name]
        failed = eng.failed_rows
        out = eng.batch_generate_json(PROMPTS, temperature=0.9, max_tokens=64)
        assert all("error" not in r for r in out), (name, out)
        assert eng.failed_rows == failed


def test_spec_config_env_overrides_and_reserve(monkeypatch):
    base = tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048)
    plain = TorchEngine(base, device="cpu")
    assert plain.worst_case_decode_window() == 2048
    monkeypatch.setenv("BCG_TPU_SPEC", "1")
    monkeypatch.setenv("BCG_TPU_SPEC_K", "6")
    monkeypatch.setenv("BCG_TPU_SPEC_NGRAM", "2")
    eng = TorchEngine(base, device="cpu", params=plain.params)
    assert eng.spec_decode and eng.spec_k == 6 and eng.spec_ngram == 2
    assert eng.worst_case_decode_window() == 2048 + 6 + 1
    monkeypatch.setenv("BCG_TPU_SPEC_K", "0")
    with pytest.raises(ValueError, match="spec_k"):
        TorchEngine(base, device="cpu", params=plain.params)
    monkeypatch.delenv("BCG_TPU_SPEC")
    monkeypatch.delenv("BCG_TPU_SPEC_K")
    ff = TorchEngine(dataclasses.replace(base, decode_fast_forward=True), device="cpu",
                     params=plain.params)
    assert ff._decode_reserve(64) == _ff_decode_slots(64)


def test_plain_loop_steps_count_is_what_the_plain_loop_takes(own_engines):
    """``total_plain_steps`` (what the fast-forward and speculative loops
    are measured against) equals the plain loop's own step count."""
    plain = own_engines["plain"]
    s0, p0 = plain.total_decode_steps, plain.total_plain_steps
    plain.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=48)
    plain.batch_generate_json(PROMPTS[:2], temperature=0.7, max_tokens=[20, 60])
    assert plain.total_plain_steps - p0 == plain.total_decode_steps - s0 > 0
    assert plain.max_kv_cache_bytes > 0


def test_tile_kernel_checks_run_before_any_build():
    """The chunk and int8 launchers' shape/type checks raise on inputs the
    kernel does not take (testable here: they run before the build)."""
    bf = dict(dtype=torch.bfloat16)
    q = torch.zeros((1, 4, 8, 128), **bf)
    k = torch.zeros((1, 16, 2, 128), **bf)
    m = torch.ones((1, 4, 16), dtype=torch.bool)
    tda._check_tile(q, k, k, m, 16, 2, int8=False)           # the bench-like form passes
    with pytest.raises(ValueError, match="head_dim 128"):
        tda._check_tile(q[..., :64], k[..., :64], k[..., :64], m, 16, 2, int8=False)
    with pytest.raises(ValueError, match="query rows"):
        tda._check_tile(torch.zeros((1, 20, 8, 128), **bf), k, k,
                        torch.ones((1, 20, 16), dtype=torch.bool), 16, 2, int8=False)
    with pytest.raises(ValueError, match="mask"):
        tda._check_tile(q, k, k, m[:, :3], 16, 2, int8=False)
    with pytest.raises(TypeError, match="int8"):
        tda._check_tile(q, k, k, m, 16, 2, int8=True)
    k8 = torch.zeros((1, 2, 16, 128), dtype=torch.int8)
    sc = torch.ones((1, 2, 16))
    tda._check_tile(q, k8, k8, m, 16, 2, int8=True, scales=(sc, sc))
    with pytest.raises(ValueError, match="scales"):
        tda._check_tile(q, k8, k8, m, 16, 2, int8=True, scales=(sc.double(), sc))
