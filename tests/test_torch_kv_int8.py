"""The int8 KV cache of the PyTorch port against the JAX package.

* **Op.** ``quantize_kv`` gives the JAX package's int8 values and
  scales bit for bit (both round half to even).  The plain versions of
  the int8 decode kernel (single step and chunk) match the Pallas
  ``_decode_kernel_allheads`` run in interpret mode, as the JAX
  package's own tests run it, at 1e-5 in f32 (same math, another
  summation order) and 2e-2 in bf16 (both round the dequantized K/V and
  the probabilities to bf16, at different points).  A group-5 case
  (H = 10, Hkv = 2: the JAX wrapper pads it to 8 rows, the port needs no
  padding) and a fully masked row (0 on both sides) are included.
* **Model.** Prefill, a prefix-cached suffix prefill, decode steps and
  decode chunks over an int8 cache give the JAX package's logits at the
  ROADMAP C-port-1 tolerances, and leave the same int8 values at every
  real slot.  The f32 scales (absmax / 127) agree to 1e-5 relative: the
  k/v they are taken of come out of the two frameworks' f32 forward
  passes a few ulps apart (sums in another order; measured 3.7e-7 in the
  first layer, 1.4e-6 in the second; ROADMAP C-port-3).
* **Engine.** Greedy output is token-identical per row to ``JaxEngine``
  with ``kv_cache_dtype="int8"`` under the plain, fast-forward and
  speculative loops.
* **Game.** An int8 + fast-forward 2H+1B game at temperature 0 gives the
  JAX game's decisions, votes, termination reason and statistics.
"""

import dataclasses

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
from bcg_tpu.ops import decode_attention as jda
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.ops import decode_attention as tda
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


TOL = {False: 1e-5, True: 2e-2}
DECODE_TOL_F32 = 1e-2     # ROADMAP C-port-1: decode logits over a quantized cache
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

def _quantized(rng, B, S, Hkv, Dh, zero_row=True):
    """Seeded K/V quantized by both frameworks: (jax int8 [B,Hkv,S,Dh],
    jax scales [B,Hkv,S], torch int8, torch scales) for k and v."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
        if zero_row:
            x[0, 3] = 0.0                          # an all-zero row: scale 1.0
        jq, js = jda.quantize_kv(jnp.asarray(x))
        tq, ts = tda.quantize_kv(torch.from_numpy(x))
        out.append((jnp.transpose(jq, (0, 2, 1, 3)), jnp.transpose(js, (0, 2, 1)),
                    tq.transpose(1, 2).contiguous(), ts.transpose(1, 2).contiguous()))
    return out


def test_quantize_kv_bit_identical_to_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17, 2, 128)).astype(np.float32) * 3
    x[1, 4] = 0.0
    x[2, 5, 0, :4] = [0.5, -0.5, 1.5, 127.0]       # exact ties round half to even
    jq, js = jda.quantize_kv(jnp.asarray(x))
    tq, ts = tda.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert np.all(ts.numpy()[1, 4] == 1.0)
    bq, bs = tda.quantize_kv(torch.from_numpy(x).to(torch.bfloat16))
    jbq, jbs = jda.quantize_kv(jnp.asarray(x).astype(jnp.bfloat16))
    assert np.array_equal(bq.numpy(), np.asarray(jbq))
    assert np.array_equal(bs.numpy(), np.asarray(jbs))
    np.testing.assert_array_equal(tda.dequantize_kv(tq, ts).numpy(),
                                  np.asarray(jda.dequantize_kv(jq, js)))


def _to(x, bf16):
    return (jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x),
            torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv", [(4, 2), (8, 2), (10, 2)], ids=["g2", "g4", "g5"])
def test_int8_decode_plain_matches_pallas_kernel(H, Hkv, bf16):
    rng = np.random.default_rng([H, Hkv, int(bf16), 8])
    B, S, Dh = 3, 300, 128                       # ragged S: the JAX wrapper pads it
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quantized(rng, B, S, Hkv, Dh)
    qj, qt = _to(rng.standard_normal((B, H, Dh)).astype(np.float32), bf16)
    m = rng.random((B, S)) < 0.6
    m[2] = False                                 # a fully masked row gives 0
    scale = Dh ** -0.5
    ref = jda.decode_attention(qj, jk, jv, jnp.asarray(m), scale, k_scale=jks, v_scale=jvs,
                               block_s=128, interpret=True)
    before = tda.decode_attention_int8.launches
    out = tda.decode_attention_int8(qt, tk, tv, tks, tvs, torch.from_numpy(m), scale)
    assert tda.decode_attention_int8.launches == before   # CPU: the plain version
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[bf16], rtol=TOL[bf16])
    assert np.all(out[2].float().numpy() == 0.0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,K", [(8, 2, 4), (8, 2, 5), (10, 2, 5)],
                         ids=["g4-ff", "g4-spec", "g5-spec"])
def test_int8_chunk_plain_matches_pallas_kernel(H, Hkv, K, bf16):
    rng = np.random.default_rng([H, Hkv, K, int(bf16)])
    B, S, Dh = 2, 260, 128
    (jk, jks, tk, tks), (jv, jvs, tv, tvs) = _quantized(rng, B, S, Hkv, Dh)
    qj, qt = _to(rng.standard_normal((B, K, H, Dh)).astype(np.float32), bf16)
    m = rng.random((B, K, S)) < 0.5
    m[1, 2] = False                              # a fully masked chunk row gives 0
    scale = Dh ** -0.5
    ref = jda.chunk_decode_attention(qj, jk, jv, jnp.asarray(m), scale, k_scale=jks,
                                     v_scale=jvs, block_s=128, interpret=True)
    out = tda.chunk_decode_attention_int8(qt, tk, tv, tks, tvs, torch.from_numpy(m), scale)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[bf16], rtol=TOL[bf16])
    assert np.all(out[1, 2].float().numpy() == 0.0)


def test_int8_plain_rounds_dequantized_kv_to_q_dtype():
    """The plain int8 version keeps no f32 K/V for a bf16 q: it equals
    the bf16 chunk form over the cache dequantized and rounded to bf16."""
    rng = np.random.default_rng(3)
    B, S, Hkv, H, K, Dh = 2, 64, 2, 8, 4, 128
    (_, _, tk, tks), (_, _, tv, tvs) = _quantized(rng, B, S, Hkv, Dh, zero_row=False)
    q = torch.from_numpy(rng.standard_normal((B, K, H, Dh)).astype(np.float32)).bfloat16()
    m = torch.from_numpy(rng.random((B, K, S)) < 0.7)
    kd = (tk.float() * tks[..., None]).bfloat16().transpose(1, 2)
    vd = (tv.float() * tvs[..., None]).bfloat16().transpose(1, 2)
    got = tda.chunk_decode_attention_int8(q, tk, tv, tks, tvs, m, 0.1)
    torch.testing.assert_close(got, tda.chunk_decode_attention(q, kd, vd, m, 0.1),
                               atol=0, rtol=0)


# ---------------------------------------------------------------- model

def _setup(seed=0):
    jspec, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jt.init_params(jspec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32)
    return jspec, spec, jp, tp


def _batch(rng, B, L):
    tokens = rng.randint(0, 256, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    for b in range(1, B):
        valid[b, : rng.randint(1, L // 2)] = False
    return tokens, valid


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _assert_cache_equal(tc, jc, real):
    """int8 values of every layer equal at the real (written, attendable)
    slots ``real`` [B, S]; f32 scales within f32 rounding of the k/v
    projection (see the module docstring)."""
    for li in range(len(tc)):
        for n in ("k", "v"):
            tv = tc[li][n].numpy().transpose(0, 2, 1, 3)[real]             # [N, Hkv, Dh]
            jv = np.asarray(jc[li][n]).transpose(0, 2, 1, 3)[real]
            assert np.array_equal(tv, jv), (li, n, int((tv != jv).sum()))
            ts = tc[li][f"{n}_scale"].numpy().transpose(0, 2, 1)[real]
            js = np.asarray(jc[li][f"{n}_scale"]).transpose(0, 2, 1)[real]
            np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)


def test_int8_cache_layout_and_nbytes():
    spec = spec_for_model(MODEL)
    c = tt.init_kv_cache(spec, 2, 40, quantized="int8")
    assert c.quantized and c[0]["k"].shape == (2, spec.num_kv_heads, 40, spec.head_dim)
    assert c[0]["k"].dtype == torch.int8 and torch.all(c[1]["v_scale"] == 1.0)
    assert tt._cache_len(c) == 40 == tt._cache_len(tt.init_kv_cache(spec, 2, 40))
    L, Hkv, Dh = spec.num_layers, spec.num_kv_heads, spec.head_dim
    assert c.nbytes() == L * 2 * 2 * Hkv * 40 * (Dh + 4)
    # The packed int4 slab (tests/test_torch_kv_int4.py) is half the bytes.
    c4 = tt.init_kv_cache(spec, 2, 40, quantized="int4")
    assert 2 * c4.nbytes() == c.nbytes() and tt.kv_is_int4(c4[0])


def test_int8_prefill_decode_steps_and_chunks_match_jax():
    """Prefill into an int8 cache, four decode steps, a fast-forward
    chunk at a device-tensor write slot and a speculative chunk at
    per-row slots: logits match the JAX package, and the cache holds the
    same int8 values and scales at every real slot."""
    jspec, spec, jp, tp = _setup(seed=2)
    rng = np.random.RandomState(5)
    B, L, S = 3, 32, 64
    tokens, valid = _batch(rng, B, L)
    jl, jc = jt.prefill(jp, jspec, jnp.asarray(tokens), jnp.asarray(valid),
                        jt.init_kv_cache(jspec, B, S, quantized="int8"))
    tc = tt.init_kv_cache(spec, B, S, quantized="int8")
    tl, tc = tt.prefill(tp, spec, torch.from_numpy(tokens).long(), torch.from_numpy(valid), tc)
    _close(tl, jl, 1e-4)
    vm = np.zeros((B, S), bool)
    vm[:, :L] = valid
    lens = valid.sum(1).astype(np.int32)
    steps = rng.randint(0, 256, (4, B)).astype(np.int32)
    for i in range(4):
        vm[:, L + i] = True
        jl, jc = jt.decode_step(jp, jspec, jnp.asarray(steps[i]), jnp.int32(L + i),
                                jnp.asarray(lens + i), jc, jnp.asarray(vm))
        tl, tc = tt.decode_step(tp, spec, torch.from_numpy(steps[i]).long(), L + i,
                                torch.from_numpy(lens + i), tc, torch.from_numpy(vm))
        _close(tl, jl, DECODE_TOL_F32)
    # Fast-forward chunk: K = 4 at a shared (device tensor) write slot.
    wp, K = L + 4, 4
    chunk = rng.randint(0, 256, (B, K)).astype(np.int32)
    cvalid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    pos = (lens + 4)[:, None] + np.arange(K)[None]
    jl, jc = jt.decode_chunk(jp, jspec, jnp.asarray(chunk), jnp.asarray(cvalid),
                             jnp.int32(wp), jnp.asarray(pos.astype(np.int32)), jc,
                             jnp.asarray(vm))
    tl, tc = tt.decode_chunk(tp, spec, torch.from_numpy(chunk).long(),
                             torch.from_numpy(cvalid), torch.tensor(wp),
                             torch.from_numpy(pos), tc, torch.from_numpy(vm))
    _close(tl, jl, DECODE_TOL_F32)
    vm[:, wp:wp + K] = cvalid
    # Speculative chunk: K1 = 5 at per-row slots.
    K1 = 5
    rwp = wp + K + np.array([0, 2, 1], np.int32)
    chunk = rng.randint(0, 256, (B, K1)).astype(np.int32)
    cvalid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], bool)
    pos = (lens + 8)[:, None] + np.arange(K1)[None]
    jl, jc = jt.decode_chunk_spec(jp, jspec, jnp.asarray(chunk), jnp.asarray(cvalid),
                                  jnp.asarray(rwp), jnp.asarray(pos.astype(np.int32)), jc,
                                  jnp.asarray(vm))
    tl, tc = tt.decode_chunk_spec(tp, spec, torch.from_numpy(chunk).long(),
                                  torch.from_numpy(cvalid), torch.from_numpy(rwp),
                                  torch.from_numpy(pos), tc, torch.from_numpy(vm))
    assert tl.shape == (B, K1, spec.vocab_size)
    _close(tl, jl, DECODE_TOL_F32)
    for b in range(B):
        vm[b, rwp[b]:rwp[b] + K1] |= cvalid[b]
    _assert_cache_equal(tc, jc, vm)


def test_int8_prefix_then_suffix_prefill_matches_jax():
    """The prefix-history path of ``_block`` over an int8 cache: the
    history is dequantized, the suffix's own KV stays unquantized."""
    jspec, spec, jp, tp = _setup(seed=3)
    rng = np.random.RandomState(2)
    B, P, Ls, tail = 2, 32, 24, 8
    ptok, pvalid = _batch(rng, 1, P)
    stok, svalid = _batch(rng, B, Ls)
    _, jpc = jt.prefill(jp, jspec, jnp.asarray(ptok), jnp.asarray(pvalid),
                        jt.init_kv_cache(jspec, 1, P, quantized="int8"))
    tpc = tt.init_kv_cache(spec, 1, P, quantized="int8")
    _, tpc = tt.prefill(tp, spec, torch.from_numpy(ptok).long(), torch.from_numpy(pvalid), tpc)
    S = P + Ls + tail
    jcache = jt.init_kv_cache(jspec, B, S, quantized="int8")
    jcache = [{n: e[n].at[:, :, :P].set(jnp.repeat(pe[n], B, 0)) for n in e}
              for e, pe in zip(jcache, jpc)]
    tcache = tt.init_kv_cache(spec, B, S, quantized="int8")
    tcache.buf[..., :P, :] = tpc.buf
    tcache.scales[..., :P] = tpc.scales
    prefix_valid = np.repeat(pvalid, B, 0)
    plens = prefix_valid.sum(1).astype(np.int32)
    jl, jc = jt.prefill_with_prefix(jp, jspec, jnp.asarray(stok), jnp.asarray(svalid), jcache,
                                    jnp.asarray(prefix_valid), jnp.asarray(plens))
    tl, tc = tt.prefill_with_prefix(tp, spec, torch.from_numpy(stok).long(),
                                    torch.from_numpy(svalid), tcache,
                                    torch.from_numpy(prefix_valid), torch.from_numpy(plens))
    _close(tl, jl, 1e-4)
    real = np.zeros((B, S), bool)
    real[:, :P] = prefix_valid
    real[:, P:P + Ls] = svalid
    _assert_cache_equal(tc, jc, real)


# --------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


PROMPTS = [
    (f"You are agent_{i}. Reach consensus.",
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION if i % 2 else VOTE)
    for i in range(5)
]


@pytest.mark.parametrize("loop", [
    {},
    dict(decode_fast_forward=True),
    dict(spec_decode=True),
], ids=["plain", "ff", "spec"])
def test_int8_engine_greedy_identical_to_jax(params, loop):
    jp, tp = params
    je_cfg = jcfg.EngineConfig(backend="jax", model_name=MODEL, max_model_len=2048,
                               kv_cache_dtype="int8", **loop)
    with pytest.warns(UserWarning, match="int8"):
        je = JaxEngine(je_cfg, params=jp)
    te = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048,
                                       kv_cache_dtype="int8", **loop),
                     device="cpu", params=tp)
    assert te.kv_int8
    a = je.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    b = te.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    assert b == a
    assert all("error" not in r for r in b)
    assert te.last_decode_steps == je.last_decode_steps
    je.shutdown()
    te.shutdown()


# ----------------------------------------------------------------- game

def _config(C, backend):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=2, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048,
                              kv_cache_dtype="int8", decode_fast_forward=True),
        llm=C.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
        metrics=C.MetricsConfig(save_results=False),
    )


def _play(sim):
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    return stats, [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds], votes


def test_int8_fast_forward_game_identical_to_jax():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    jc, tc = _config(jcfg, "jax"), _config(tcfg, "torch")
    with pytest.warns(UserWarning, match="int8"):
        jsim = JSimulation(jc, engine=JaxEngine(jc.engine, params=jp))
    tsim = TSimulation(tc, engine=TorchEngine(tc.engine, device="cpu", params=tp))
    jstats, jdec, jvotes = _play(jsim)
    tstats, tdec, tvotes = _play(tsim)
    assert tdec == jdec
    assert tvotes == jvotes
    assert tsim.game.termination_reason == jsim.game.termination_reason is not None
    assert tstats == jstats
    assert len(tstats) > 40
    assert tsim.engine.failed_rows == jsim.engine.failed_rows == 0
    assert tsim.engine.fast_forward and tsim.engine.kv_int8


def test_int8_slot_bytes_and_reserve():
    eng = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL,
                                        kv_cache_dtype="int8"), device="cpu")
    spec = eng.spec
    assert eng._kv_slot_bytes == spec.num_kv_heads * (2 * spec.head_dim + 8)
    bf = TorchEngine(dataclasses.replace(eng.config, kv_cache_dtype="bfloat16"),
                     device="cpu", params=eng.params)
    assert bf._kv_slot_bytes == spec.num_kv_heads * spec.head_dim * 4
