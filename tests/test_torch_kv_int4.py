"""The packed-int4 KV cache of the PyTorch port against the JAX package.

* **Packing contract** (mirrors ``tests/test_int4_kv.py``): the
  half-step error bound against the bf16-rounded scale, low nibbles
  holding the first half of the head dim, odd head dims refused.
* **Op.** ``quantize_kv_int4`` gives the JAX package's packed bytes and
  bf16 scales bit for bit (f32 and bf16 inputs, exact ties, an all-zero
  row); ``unpack_kv_int4`` / ``dequantize_kv_int4`` likewise.
* **Cache paths.** The dense int4 slab is ``[B, Hkv, S, Dh/2]`` int8
  with bf16 scales (the layout marker); a written entry reads back as
  the ``dequantize_kv_int4`` oracle; dense int4 decode attention and the
  chunk form equal the dequantize-then-attend oracle (ROADMAP C-ref-2:
  int4 is held to this oracle, not to the bf16-logits tolerance that the
  JAX package's own test fails under jax 0.9, C-ref-1).
* **Model.** Prefill, decode steps and both chunk forms over a dense
  int4 cache give the JAX package's logits at the C-port-1 tolerances
  and the same packed bytes at every real slot.
* **Engine.** Greedy output over the dense int4 cache (which warns, as
  in the JAX package) is token-identical to ``JaxEngine``'s under the
  plain, fast-forward and speculative loops.
* **Game.** A paged int4 fast-forward 2H+1B game at temperature 0 gives
  the JAX game's decisions, votes, termination reason and statistics.
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
from bcg_tpu.models import quantize as jq
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.models import quantize as tq
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.ops import decode_attention as tda
from bcg_tpu_torch.ops import paged_attention as tpa
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation
import _torch_jax_obs_state


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


MODEL = "bcg-tpu/tiny-test"
DECODE_TOL_F32 = 1e-2     # ROADMAP C-port-1

VOTE = {
    "type": "object",
    "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
    "required": ["decision"],
    "additionalProperties": False,
}
DECISION = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 8},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
    },
    "required": ["internal_strategy", "value"],
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


def _bits(x):
    """bf16 as its 16 bits, anything else as is (numpy)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# --------------------------------------------------------- packing contract

class TestPackingContract:
    def test_roundtrip_half_step_bound(self):
        x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 7, 2, 16))
                             .astype(np.float32) * 5)
        packed, scale = tq.quantize_kv_int4(x)
        assert packed.shape == (3, 7, 2, 8) and packed.dtype == torch.int8
        assert scale.shape == (3, 7, 2) and scale.dtype == torch.bfloat16
        back = tq.dequantize_kv_int4(packed, scale)
        bound = scale.float()[..., None] / 2 + 1e-6
        assert torch.all((back - x).abs() <= bound)

    def test_nibble_halves_low_first(self):
        x = torch.arange(-8, 8, dtype=torch.float32)[None, :]
        packed, scale = tq.quantize_kv_int4(x)
        q = torch.clamp(torch.round(x / scale.float()[..., None]), -8, 7).to(torch.int8)
        assert torch.equal(tq.unpack_kv_int4(packed), q)
        # Byte j: element j low, element j + 8 high.
        assert int(packed[0, 0]) & 0x0F == int(q[0, 0]) & 0x0F
        assert int(packed[0, 0]) >> 4 == int(q[0, 8])

    def test_odd_head_dim_rejected(self):
        with pytest.raises(ValueError, match="even head dim"):
            tq.quantize_kv_int4(torch.zeros((2, 15)))
        spec = dataclasses.replace(spec_for_model(MODEL), head_dim=15)
        with pytest.raises(ValueError, match="even head dim"):
            tt.init_kv_cache(spec, 1, 8, quantized="int4")
        with pytest.raises(ValueError, match="even head dim"):
            tpa.init_block_pool(spec, 4, 2, quantized="int4")


# --------------------------------------------------------------------- op

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_quantize_kv_int4_bit_identical_to_jax(bf16):
    rng = np.random.default_rng(int(bf16))
    x = (rng.standard_normal((3, 17, 2, 128)) * 3).astype(np.float32)
    x[1, 4] = 0.0                                    # an all-zero row: scale 1
    x[2, 5, 0, :4] = [3.5, -3.5, 0.5, 7.0]           # exact ties round half to even
    jx = jnp.asarray(x).astype(jnp.bfloat16) if bf16 else jnp.asarray(x)
    tx = torch.from_numpy(x).to(torch.bfloat16) if bf16 else torch.from_numpy(x)
    jp, js = jq.quantize_kv_int4(jx)
    tp, ts = tq.quantize_kv_int4(tx)
    assert tp.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert np.array_equal(_bits(ts), _bits(js))
    assert np.array_equal(tq.unpack_kv_int4(tp).numpy(), np.asarray(jq.unpack_kv_int4(jp)))
    np.testing.assert_array_equal(tq.dequantize_kv_int4(tp, ts).numpy(),
                                  np.asarray(jq.dequantize_kv_int4(jp, js)))
    assert torch.all(ts[1, 4].float() == 1.0)


def test_kv_int4_layout():
    assert tq.kv_int4_layout(128) == (64, torch.bfloat16)
    assert jq.kv_int4_layout(128)[0] == 64


# ------------------------------------------------------------ cache paths

def _spec1():
    return dataclasses.replace(spec_for_model(MODEL), num_heads=4, num_kv_heads=2,
                               head_dim=16, num_layers=1)


def test_dense_slab_layout_and_marker():
    spec = spec_for_model(MODEL)
    c = tt.init_kv_cache(spec, 2, 8, quantized="int4")
    assert tt.kv_is_int4(c[0]) and c.quantized
    assert c[0]["k"].shape == (2, spec.num_kv_heads, 8, spec.head_dim // 2)
    assert c[0]["k"].dtype == torch.int8 and c[0]["k_scale"].dtype == torch.bfloat16
    assert not tt.kv_is_int4(tt.init_kv_cache(spec, 2, 8, quantized="int8")[0])
    assert tt._cache_len(c) == 8
    L, Hkv, Dh = spec.num_layers, spec.num_kv_heads, spec.head_dim
    assert c.nbytes() == L * 2 * 2 * Hkv * 8 * (Dh // 2 + 2)
    assert tt._kv_quantizer(c[0]) is tq.quantize_kv_int4
    assert tt._kv_dequantizer(c[0]) is tq.dequantize_kv_int4


def test_write_then_read_matches_manual_dequant():
    rng = np.random.default_rng(1)
    B, S = 2, 8
    k = torch.from_numpy(rng.standard_normal((B, S, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, 2, 16)).astype(np.float32))
    entry = tt._write_cache(tt.init_kv_cache(_spec1(), B, S + 2, quantized="int4")[0],
                            k, v, 0)
    got = tt._dequant_slice(entry, "k", S, torch.float32)
    want = tq.dequantize_kv_int4(*tq.quantize_kv_int4(k))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    # Per-row slots write the same bytes as a shared slot.
    rows = tt._write_cache(tt.init_kv_cache(_spec1(), B, S + 2, quantized="int4")[0],
                           k, v, torch.tensor([0, 0]))
    assert torch.equal(rows["k"], entry["k"]) and torch.equal(rows["v_scale"], entry["v_scale"])


@pytest.mark.parametrize("form", ["step", "chunk"])
def test_dense_attention_matches_dequant_oracle(form):
    rng = np.random.default_rng(2)
    B, S, K = 2, 8, 1 if form == "step" else 3
    k = torch.from_numpy(rng.standard_normal((B, S, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, 2, 16)).astype(np.float32))
    entry = tt._write_cache(tt.init_kv_cache(_spec1(), B, S, quantized="int4")[0], k, v, 0)
    q = torch.from_numpy(rng.standard_normal((B, K, 4, 16)).astype(np.float32))
    kd = tq.dequantize_kv_int4(*tq.quantize_kv_int4(k))
    vd = tq.dequantize_kv_int4(*tq.quantize_kv_int4(v))
    if form == "step":
        mask = torch.from_numpy(rng.random((B, S)) < 0.7)
        mask[:, 0] = True
        out = tt._cache_attention(q, entry, mask, 0.25)
        want = tt._xla_attention(q, kd, vd, mask[:, None, :], 0.25)
    else:
        mask = torch.from_numpy(rng.random((B, K, S)) < 0.7)
        mask[:, :, 0] = True
        out = tda.chunk_decode_attention(q, *tt._dequant_view(entry, q.dtype), mask, 0.25)
        want = tt._xla_attention(q, kd, vd, mask, 0.25)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ model

def _setup(seed):
    jspec, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jt.init_params(jspec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32)
    return jspec, spec, jp, tp


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def test_int4_dense_model_matches_jax():
    """Left-padded prefill into a dense int4 cache, three decode steps, a
    fast-forward chunk and a speculative chunk: logits match the JAX
    package, and the packed bytes agree at every real slot (scales to
    f32 rounding, then bf16: ROADMAP C-port-3)."""
    jspec, spec, jp, tp = _setup(seed=2)
    rng = np.random.RandomState(5)
    B, L, S = 3, 24, 48
    tokens = rng.randint(0, 256, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    valid[1, :5] = False
    valid[2, :11] = False
    jl, jc = jt.prefill(jp, jspec, jnp.asarray(tokens), jnp.asarray(valid),
                        jt.init_kv_cache(jspec, B, S, quantized="int4"))
    tl, tc = tt.prefill(tp, spec, torch.from_numpy(tokens).long(), torch.from_numpy(valid),
                        tt.init_kv_cache(spec, B, S, quantized="int4"))
    _close(tl, jl, 1e-4)
    vm = np.zeros((B, S), bool)
    vm[:, :L] = valid
    lens = valid.sum(1).astype(np.int32)
    steps = rng.randint(0, 256, (3, B)).astype(np.int32)
    for i in range(3):
        vm[:, L + i] = True
        jl, jc = jt.decode_step(jp, jspec, jnp.asarray(steps[i]), jnp.int32(L + i),
                                jnp.asarray(lens + i), jc, jnp.asarray(vm))
        tl, tc = tt.decode_step(tp, spec, torch.from_numpy(steps[i]).long(), L + i,
                                torch.from_numpy(lens + i), tc, torch.from_numpy(vm))
        _close(tl, jl, DECODE_TOL_F32)
    wp, K = L + 3, 4
    chunk = rng.randint(0, 256, (B, K)).astype(np.int32)
    cvalid = np.array([[1, 1, 0, 0], [1, 1, 1, 1], [1, 0, 0, 0]], bool)
    pos = (lens + 3)[:, None] + np.arange(K)[None]
    jl, jc = jt.decode_chunk(jp, jspec, jnp.asarray(chunk), jnp.asarray(cvalid), jnp.int32(wp),
                             jnp.asarray(pos.astype(np.int32)), jc, jnp.asarray(vm))
    tl, tc = tt.decode_chunk(tp, spec, torch.from_numpy(chunk).long(), torch.from_numpy(cvalid),
                             torch.tensor(wp), torch.from_numpy(pos), tc, torch.from_numpy(vm))
    _close(tl, jl, DECODE_TOL_F32)
    vm[:, wp:wp + K] = cvalid
    K1 = 5
    rwp = wp + K + np.array([0, 2, 1], np.int32)
    chunk = rng.randint(0, 256, (B, K1)).astype(np.int32)
    cvalid = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1], [1, 0, 0, 0, 0]], bool)
    pos = (lens + 7)[:, None] + np.arange(K1)[None]
    jl, jc = jt.decode_chunk_spec(jp, jspec, jnp.asarray(chunk), jnp.asarray(cvalid),
                                  jnp.asarray(rwp), jnp.asarray(pos.astype(np.int32)), jc,
                                  jnp.asarray(vm))
    tl, tc = tt.decode_chunk_spec(tp, spec, torch.from_numpy(chunk).long(),
                                  torch.from_numpy(cvalid), torch.from_numpy(rwp),
                                  torch.from_numpy(pos), tc, torch.from_numpy(vm))
    _close(tl, jl, DECODE_TOL_F32)
    for b in range(B):
        vm[b, rwp[b]:rwp[b] + K1] |= cvalid[b]
    for li in range(len(tc)):
        for n in ("k", "v"):
            t = tc[li][n].numpy().transpose(0, 2, 1, 3)[vm]
            j = np.asarray(jc[li][n]).transpose(0, 2, 1, 3)[vm]
            assert np.array_equal(t, j), (li, n, int((t != j).sum()))
            ts = tc[li][f"{n}_scale"].float().numpy().transpose(0, 2, 1)[vm]
            js = np.asarray(jc[li][f"{n}_scale"].astype(jnp.float32)).transpose(0, 2, 1)[vm]
            np.testing.assert_allclose(ts, js, rtol=2 ** -7, atol=0)


# ----------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


PROMPTS = [
    (f"You are agent_{i}. Reach consensus.",
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION if i % 2 else VOTE)
    for i in range(4)
]


@pytest.mark.parametrize("loop", [{}, dict(decode_fast_forward=True), dict(spec_decode=True)],
                         ids=["plain", "ff", "spec"])
def test_int4_dense_engine_greedy_identical_to_jax(params, loop):
    jp, tp = params
    with pytest.warns(UserWarning, match="int4"):
        je = JaxEngine(jcfg.EngineConfig(backend="jax", model_name=MODEL, max_model_len=2048,
                                         kv_cache_dtype="int4", **loop), params=jp)
    with pytest.warns(UserWarning, match="without paged_kv"):
        te = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL,
                                           max_model_len=2048, kv_cache_dtype="int4", **loop),
                         device="cpu", params=tp)
    assert te.kv_quantized == "int4" and te._paged is None
    a = je.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=48)
    b = te.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=48)
    assert b == a
    assert all("error" not in r for r in b)
    assert te.last_decode_steps == je.last_decode_steps
    je.shutdown()
    te.shutdown()


def test_int4_slot_bytes_half_of_int8(params):
    _, tp = params
    spec = spec_for_model(MODEL)
    cfg = tcfg.EngineConfig(backend="torch", model_name=MODEL, kv_cache_dtype="int4",
                            paged_kv=True)
    e4 = TorchEngine(cfg, device="cpu", params=tp)
    e8 = TorchEngine(dataclasses.replace(cfg, kv_cache_dtype="int8"), device="cpu", params=tp)
    assert e4._kv_slot_bytes == spec.num_kv_heads * (spec.head_dim + 4)
    assert 2 * e4._kv_slot_bytes == e8._kv_slot_bytes
    # The pool's own leaves: an int4 block is half an int8 block.
    assert 2 * e4._paged.block_bytes_dev == e8._paged.block_bytes_dev


# ------------------------------------------------------------------- game

def _config(C, backend):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=2, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048,
                              kv_cache_dtype="int4", paged_kv=True,
                              decode_fast_forward=True),
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


def test_paged_int4_fast_forward_game_identical_to_jax():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    jc, tc = _config(jcfg, "jax"), _config(tcfg, "torch")
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
    te, je = tsim.engine, jsim.engine
    assert te.fast_forward and te.kv_cache_dtype == "int4" and te._paged is not None
    keys = ("blocks_resident", "blocks_free", "prefix_hit_rate")
    assert {k: te.kv_pool_stats()[k] for k in keys} == {k: je.kv_pool_stats()[k] for k in keys}
    assert te.kv_pool_stats()["prefix_hit_rate"] > 0
