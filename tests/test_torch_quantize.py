"""int8 (W8A8) and int4 (W4A16) weight quantization of the PyTorch port
against the JAX package.

* **Op.** ``quantize_weight`` / ``quantize_weight_int4`` give the JAX
  package's int8 values and f32 scales, packed int4 bytes and bf16 group
  scales bit for bit, from f32 and bf16 sources, with ``int4_group_for``'s
  shrink at tiny-test's widths (groups of 32 and 64).  ``unpack_int4`` and
  ``dequantize_int4`` are exact.  The int8 ``dense`` equals the jitted
  JAX ``dense`` bit for bit (the port multiplies by the f32 reciprocal of
  127 and 7 where XLA rewrites a division by those constants); the
  ``BCG_TPU_W8A16_PREFILL`` branch likewise.
* **B5's plain version.** Against ``w4a16_matmul(..., interpret=True)``
  (the Pallas kernel, at the shapes it takes: groups of 128) at 1e-5
  relative in f32 — the same products summed in another order; against
  the XLA dequantize route (which rounds the product to bf16) within one
  bf16 rounding, 2**-8 relative.  Ragged rows and 3-D leading dims.
* **Trees.** ``quantize_params`` on a tied-embedding spec gains a
  quantized ``lm_head``; a JAX-quantized tree carried across by
  ``params_from_numpy`` equals the port's own quantization of the same
  weights; ``init_params(leaf_transform=...)`` is born quantized.
* **Model.** Prefill and decode-step logits from a JAX-quantized tree:
  int8 at the f32 parity tolerances of ``test_torch_model.py`` (1e-4
  prefill, 1e-2 decode over the bf16 cache); int4 at 0.1 absolute, about
  three bf16 steps of logits of magnitude ~4, because the JAX package on
  the CPU takes the dequantize route, whose bf16 product rounds the output
  of every int4 matmul (seven a layer, and the LM head) to bf16, while the
  port's B5 plain version keeps f32 as the TPU kernel does (measured over
  four seeds: 0.025-0.037 prefill, 0.050-0.072 after four decode steps;
  ROADMAP C-port-5).  The greedy token of every step agrees.
* **Engine and game.** ``TorchEngine`` with int8 weights is greedy
  token-identical to ``JaxEngine`` on the decision and vote schemas
  under the plain, fast-forward and speculative loops; int4 likewise at
  greedy token identity; an int8-weights + int8-KV + fast-forward game
  gives the JAX game's decisions, votes and statistics.  A shared tree of
  another mode raises; the CLI takes ``--quantization``.
"""

import dataclasses
import warnings

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
from bcg_tpu.ops.w4_matmul import w4a16_matmul as j_w4a16, w4a16_supported
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.models import quantize as tq
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import DenseRoute, spec_for_model
from bcg_tpu_torch.models.convert import _to_tensor, init_params, params_from_numpy
from bcg_tpu_torch.ops import w4_matmul as tw4
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pools spinning
    against each other slow these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL = "bcg-tpu/tiny-test"
W4_F32_RTOL = 1e-5        # B5 plain vs the Pallas kernel in interpret mode
BF16_ROUNDING = 2.0 ** -8  # one bf16 rounding, relative
INT4_LOGIT_TOL = 0.1      # ROADMAP C-port-5: f32 B5 output vs JAX's bf16-rounded route

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
PROMPTS = [
    (f"You are agent_{i}. Reach consensus.",
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION if i % 2 else VOTE)
    for i in range(5)
]


def named_arrays(tree):
    """The JAX param tree by logical name, a quantized leaf by its parts
    (``layers.0.wq.q``, ``.scale``; ``.q4``, ``.gscale``)."""
    out = []

    def leaf(name, v):
        if isinstance(v, dict):
            out.extend((f"{name}.{p}", np.asarray(a)) for p, a in v.items())
        else:
            out.append((name, np.asarray(v)))

    for k, v in tree.items():
        if k == "layers":
            for i, layer in enumerate(v):
                for n, a in layer.items():
                    leaf(f"layers.{i}.{n}", a)
        else:
            leaf(k, v)
    return out


def _bits(t):
    """A tensor's raw bits as numpy (bf16 through its 16-bit payload)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _src(rng, shape, dtype):
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    jw = jnp.asarray(w, dtype)
    return jw, _to_tensor(np.asarray(jw))


# ------------------------------------------------------------------- op

# tiny-test's wq (64 -> 64: group 32), wk (F = 32), w_down (128 -> 64:
# group 64), tiny-dh128's wq (group 128) and a two-group weight.
SHAPES = [(64, 64), (64, 32), (128, 64), (256, 256), (512, 96)]


@pytest.mark.parametrize("src", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_weight_quantizers_bit_identical_to_jax(shape, src):
    rng = np.random.default_rng(list(shape))
    jw, tw = _src(rng, shape, src)
    a, b = jq.quantize_weight(jw), tq.quantize_weight(tw)
    assert b["q"].dtype == torch.int8 and b["scale"].dtype == torch.float32
    assert b["q"].stride() == (1, shape[0])          # stored output-major
    assert np.array_equal(_bits(a["q"]), _bits(b["q"]))
    assert np.array_equal(_bits(a["scale"]), _bits(b["scale"]))
    a4, b4 = jq.quantize_weight_int4(jw), tq.quantize_weight_int4(tw)
    g = tq.int4_group_for(shape[0])
    assert g == jq.int4_group_for(shape[0]) == min(shape[0] // 2, 128)
    assert tuple(b4["q4"].shape) == (shape[0] // 2, shape[1])
    assert tuple(b4["gscale"].shape) == (shape[0] // g, shape[1])
    assert b4["q4"].dtype == torch.int8 and b4["gscale"].dtype == torch.bfloat16
    assert np.array_equal(_bits(a4["q4"]), _bits(b4["q4"]))
    assert np.array_equal(_bits(a4["gscale"]), _bits(b4["gscale"]))


def test_int4_group_shrinks_as_in_jax():
    for d in (64, 96, 128, 200, 256, 4096, 12288):
        assert tq.int4_group_for(d) == jq.int4_group_for(d)
    with pytest.raises(ValueError, match="even"):
        tq.int4_group_for(63)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_unpack_and_dequantize_exact(shape):
    rng = np.random.default_rng(shape[0] + shape[1])
    jw, tw = _src(rng, shape, jnp.bfloat16)
    a = jq.quantize_weight_int4(jw)
    b = {"q4": _to_tensor(np.asarray(a["q4"])), "gscale": _to_tensor(np.asarray(a["gscale"]))}
    un = tq.unpack_int4(b["q4"])
    assert un.dtype == torch.int8 and int(un.min()) >= -8 and int(un.max()) <= 7
    assert np.array_equal(_bits(jq.unpack_int4(a["q4"])), _bits(un))
    assert np.array_equal(_bits(jq.dequantize_int4(a)), _bits(tq.dequantize_int4(b)))
    # An independent oracle of the nibble layout: row i low, row P + i high.
    p = np.asarray(a["q4"]).astype(np.int8)
    oracle = np.concatenate([(p << 4).astype(np.int8) >> 4, p >> 4], axis=0)
    assert np.array_equal(oracle, un.numpy())


@pytest.mark.parametrize("x_dtype", [jnp.float32, jnp.bfloat16], ids=["x-f32", "x-bf16"])
@pytest.mark.parametrize("w_dtype", [jnp.float32, jnp.bfloat16], ids=["w-f32", "w-bf16"])
@pytest.mark.parametrize("lead", [(7,), (3, 5)], ids=["2d", "3d"])
def test_int8_dense_bit_identical_to_jax(lead, w_dtype, x_dtype):
    rng = np.random.default_rng(len(lead))
    jw, tw = _src(rng, (128, 96), w_dtype)
    jx, tx = _src(rng, lead + (128,), x_dtype)
    qa, qb = jq.quantize_weight(jw), tq.quantize_weight(tw)
    for out_dtype in (None, jnp.float32):
        want = jax.jit(jq.dense, static_argnums=2)(jx, qa, out_dtype)
        got = tq.dense(tx, qb, None if out_dtype is None else torch.float32)
        assert tuple(got.shape) == lead + (96,)
        assert np.array_equal(_bits(want), _bits(got))


def test_w8a16_prefill_matches_explicit_dequant_and_jax(monkeypatch):
    monkeypatch.setenv("BCG_TPU_W8A16_PREFILL", "4")
    rng = np.random.default_rng(0)
    jw, tw = _src(rng, (32, 16), jnp.bfloat16)
    qa, qb = jq.quantize_weight(jw), tq.quantize_weight(tw)
    jx, tx = _src(rng, (8, 32), jnp.bfloat16)
    route = tq.dense_route_from_env()
    assert route == DenseRoute(w8a16_rows=4, w4_kernel=True)
    got = tq.dense(tx, qb, route=route)
    w_bf = (qb["q"].float() * qb["scale"]).to(torch.bfloat16)
    assert torch.equal(got, (tx.to(torch.bfloat16) @ w_bf).to(tx.dtype))
    assert np.array_equal(_bits(jax.jit(jq.dense)(jx, qa)), _bits(got))


def test_w8a16_below_threshold_keeps_w8a8(monkeypatch):
    rng = np.random.default_rng(1)
    _, tw = _src(rng, (32, 16), jnp.bfloat16)
    qb = tq.quantize_weight(tw)
    _, tx = _src(rng, (2, 32), jnp.bfloat16)
    monkeypatch.delenv("BCG_TPU_W8A16_PREFILL", raising=False)
    base = tq.dense(tx, qb)
    monkeypatch.setenv("BCG_TPU_W8A16_PREFILL", "1000")
    assert torch.equal(base, tq.dense(tx, qb, route=tq.dense_route_from_env()))


# ------------------------------------------------------------- B5 plain

@pytest.mark.parametrize("xshape", [(8, 512), (10, 512), (1, 512), (2, 4, 512)],
                         ids=["m8", "ragged-m10", "m1", "3d"])
def test_w4_plain_matches_pallas_interpret(xshape):
    rng = np.random.default_rng(xshape[0])
    jw, _ = _src(rng, (512, 128), jnp.bfloat16)
    jx, tx = _src(rng, xshape, jnp.bfloat16)
    qa = jq.quantize_weight_int4(jw)
    assert w4a16_supported((int(np.prod(xshape[:-1])), 512), qa["q4"].shape, qa["gscale"].shape)
    want = np.asarray(j_w4a16(jx, qa["q4"], qa["gscale"], interpret=True), np.float32)
    q4, gs = _to_tensor(np.asarray(qa["q4"])), _to_tensor(np.asarray(qa["gscale"]))
    got = tw4.w4a16_matmul(tx, q4, gs)
    assert got.dtype == torch.float32 and tuple(got.shape) == xshape[:-1] + (128,)
    np.testing.assert_allclose(got.numpy(), want, rtol=W4_F32_RTOL,
                               atol=W4_F32_RTOL * np.abs(want).max())


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_w4_plain_within_one_bf16_rounding_of_the_xla_route(shape):
    """Every tiny-model shape, groups of 32/64/128 included: the JAX
    package's route (``x.bf16 @ dequantize_int4``, rounded to bf16) is the
    plain version's f32 result rounded once."""
    rng = np.random.default_rng(shape[1])
    jw, _ = _src(rng, shape, jnp.float32)
    jx, tx = _src(rng, (10, shape[0]), jnp.float32)
    qa = jq.quantize_weight_int4(jw)
    want = np.asarray(j_w4a16(jx, qa["q4"], qa["gscale"]), np.float32)   # XLA route off-TPU
    got = tw4.w4a16_matmul_plain(tx, _to_tensor(np.asarray(qa["q4"])),
                                 _to_tensor(np.asarray(qa["gscale"]))).numpy()
    np.testing.assert_allclose(want, got, rtol=BF16_ROUNDING, atol=1e-6)


def test_int4_dense_dispatch(monkeypatch):
    """Up to 256 rows through B5 (its plain version here, f32 before the
    cast), more rows and the CPU kill switch through the dequantize route
    (bf16 product, as the JAX package's ``dense`` on the CPU)."""
    rng = np.random.default_rng(3)
    jw, tw = _src(rng, (256, 64), jnp.bfloat16)
    qb = tq.quantize_weight_int4(tw)
    _, x = _src(rng, (300, 256), jnp.bfloat16)
    route = (x.to(torch.bfloat16) @ tq.dequantize_int4(qb))
    small = tq.dense(x[:256], qb, torch.float32)
    assert torch.equal(small, tw4.w4a16_matmul_plain(x[:256], qb["q4"], qb["gscale"]))
    assert torch.equal(tq.dense(x, qb, torch.float32), route.float())
    monkeypatch.setenv("BCG_TPU_DISABLE_W4_KERNEL", "1")
    off = tq.dense_route_from_env()
    assert off == DenseRoute(w8a16_rows=0, w4_kernel=False)
    assert torch.equal(tq.dense(x[:10], qb, torch.float32, route=off), route[:10].float())


def test_engine_resolves_the_dense_route_once(monkeypatch):
    """The engine reads the two routing flags at construction and carries
    them on its spec; a later change of the environment does not reach a
    forward pass, and the registry's spec keeps the defaults."""
    monkeypatch.setenv("BCG_TPU_W8A16_PREFILL", "4")
    monkeypatch.setenv("BCG_TPU_DISABLE_W4_KERNEL", "1")
    cfg = tcfg.EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test",
                            max_model_len=256, quantization="int4")
    eng = TorchEngine(cfg, device="cpu")
    assert eng.spec.dense_route == DenseRoute(w8a16_rows=4, w4_kernel=False)
    monkeypatch.delenv("BCG_TPU_W8A16_PREFILL")
    monkeypatch.delenv("BCG_TPU_DISABLE_W4_KERNEL")
    assert eng.spec.dense_route == DenseRoute(w8a16_rows=4, w4_kernel=False)
    assert spec_for_model("bcg-tpu/tiny-test").dense_route == DenseRoute()
    eng.shutdown()


def test_w4_kernel_checks_refuse_what_it_cannot_take():
    """The CUDA wrapper's shape checks (they run before any launch, so the
    CPU can reach them): a group under 32 rows, a ragged output width,
    too many rows, mismatched widths."""
    q = tq.quantize_weight_int4(torch.randn(64, 40))
    with pytest.raises(ValueError, match="multiple of 16"):
        tw4._check(torch.zeros(4, 64, dtype=torch.bfloat16), q["q4"], q["gscale"])
    q = tq.quantize_weight_int4(torch.randn(32, 32))         # group 16
    with pytest.raises(ValueError, match="groups"):
        tw4._check(torch.zeros(4, 32, dtype=torch.bfloat16), q["q4"], q["gscale"])
    q = tq.quantize_weight_int4(torch.randn(64, 32))
    with pytest.raises(ValueError, match="rows"):
        tw4._check(torch.zeros(257, 64, dtype=torch.bfloat16), q["q4"], q["gscale"])
    with pytest.raises(ValueError, match="do not match"):
        tw4._check(torch.zeros(4, 66, dtype=torch.bfloat16), q["q4"], q["gscale"])
    with pytest.raises(TypeError):
        tw4._check(torch.zeros(4, 64), q["q4"], q["gscale"])


def test_split_plan_fills_the_card():
    # bench-8b: wk/wv (8 column blocks) split the contraction, the LM head
    # does not; every split keeps at least 4 stages; stages cover P once.
    for M, P, F in ((10, 2048, 1024), (10, 2048, 151936), (50, 6144, 4096),
                    (256, 2048, 12288), (1, 32, 32)):
        mt, splits, per = tw4.split_plan(M, P, F, 132)
        nkt = P // 32
        assert mt in (1, 2, 4) and 16 * mt >= min(M, 64)
        assert (splits - 1) * per < nkt <= splits * per
        assert splits == 1 or per >= 4
    assert tw4.split_plan(10, 2048, 1024, 132)[1] > 1
    assert tw4.split_plan(10, 2048, 151936, 132)[1] == 1


# ---------------------------------------------------------------- trees

@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_tied_embeddings_gain_a_quantized_head(mode):
    spec = dataclasses.replace(spec_for_model(MODEL), tie_embeddings=True)
    gen = torch.Generator().manual_seed(0)
    params = init_params(spec, gen, "cpu")
    assert "lm_head" not in params
    q = tq.quantize_params(params, spec, mode=mode)
    assert tq.is_quantized(q["lm_head"]) and tq.is_int4(q["lm_head"]) == (mode == "int4")
    assert q["embed"].dtype == torch.bfloat16 and "layers.0.wq" in params
    ref = tq._quantizer(mode)(params["embed"].T)
    for part in ref:
        assert torch.equal(ref[part], q["lm_head"][part])
    # A leaf-transform tree gets its head afterwards, in place.
    born = init_params(spec, torch.Generator().manual_seed(0), "cpu",
                       leaf_transform=tq.quantize_leaf_transform(spec, mode))
    assert "lm_head" not in born
    tq.ensure_quantized_head(born, spec, mode)
    for part in ref:
        assert torch.equal(born["lm_head"][part], ref[part])


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_params_born_quantized_equals_quantize_params(mode):
    spec = spec_for_model(MODEL)
    bf = init_params(spec, torch.Generator().manual_seed(4), "cpu")
    born = init_params(spec, torch.Generator().manual_seed(4), "cpu",
                       leaf_transform=tq.quantize_leaf_transform(spec, mode))
    ref = tq.quantize_params(dict(bf), spec, consume=True, mode=mode)
    assert set(born) == set(ref)
    for name, leaf in ref.items():
        if isinstance(leaf, dict):
            assert set(born[name]) == set(leaf)
            for part in leaf:
                assert torch.equal(born[name][part], leaf[part]), (name, part)
        else:
            assert torch.equal(born[name], leaf)
    quantized = [n for n, v in born.items() if isinstance(v, dict)]
    assert len(quantized) == 7 * spec.num_layers + 1      # + lm_head
    assert not isinstance(born["embed"], dict)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_jax_quantized_tree_carries_across(mode):
    jspec, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jt.init_params(jspec, jax.random.PRNGKey(2), dtype=jnp.float32)
    jq_tree = jq.quantize_params(jp, jspec, mode=mode)
    tp = params_from_numpy(named_arrays(jq_tree), spec, "cpu", torch.float32)
    own = tq.quantize_params(params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32),
                             spec, mode=mode)
    assert set(tp) == set(own)
    for name, leaf in own.items():
        if isinstance(leaf, dict):
            for part in leaf:
                assert tp[name][part].dtype == leaf[part].dtype
                assert tp[name][part].stride() == leaf[part].stride()
                assert np.array_equal(_bits(tp[name][part]), _bits(leaf[part])), (name, part)
    with pytest.raises(ValueError, match="shape"):
        cut = "layers.0.wq." + ("scale" if mode == "int8" else "gscale")
        bad = [(n, a[:-1] if n == cut else a) for n, a in named_arrays(jq_tree)]
        params_from_numpy(bad, spec, "cpu", torch.float32)


# ---------------------------------------------------------------- model

def _model_logits(params, spec, mod, tokens, valid, steps, cache):
    """Prefill plus decode steps through ``mod`` (the JAX or the port's
    transformer); returns the stacked logits."""
    B, L = tokens.shape
    if mod is jt:
        logits, cache = jt.prefill(params, spec, jnp.asarray(tokens), jnp.asarray(valid), cache)
        outs = [np.asarray(logits)]
        vm = np.zeros((B, cache[0]["k"].shape[1]), bool)
        vm[:, :L] = valid
        for i in range(steps.shape[1]):
            vm[:, L + i] = True
            logits, cache = jt.decode_step(params, spec, jnp.asarray(steps[:, i]), L + i,
                                           jnp.asarray(valid.sum(1) + i), cache, jnp.asarray(vm))
            outs.append(np.asarray(logits))
        return np.stack(outs)
    logits, cache = tt.prefill(params, spec, torch.as_tensor(tokens), torch.as_tensor(valid),
                               cache)
    outs = [logits.numpy()]
    vm = torch.zeros((B, tt._cache_len(cache)), dtype=torch.bool)
    vm[:, :L] = torch.as_tensor(valid)
    for i in range(steps.shape[1]):
        vm[:, L + i] = True
        logits, cache = tt.decode_step(params, spec, torch.as_tensor(steps[:, i]), L + i,
                                       torch.as_tensor(valid.sum(1) + i), cache, vm)
        outs.append(logits.numpy())
    return np.stack(outs)


@pytest.mark.parametrize("mode,prefill_tol,decode_tol", [
    ("int8", 1e-4, 1e-2), ("int4", INT4_LOGIT_TOL, INT4_LOGIT_TOL)], ids=["int8", "int4"])
def test_quantized_model_logits_match_jax(mode, prefill_tol, decode_tol):
    jspec, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jq.quantize_params(jt.init_params(jspec, jax.random.PRNGKey(3), dtype=jnp.float32),
                            jspec, mode=mode)
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32)
    rng = np.random.RandomState(0)
    B, L, S = 3, 24, 32
    tokens = rng.randint(0, 256, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    valid[1, :5] = False
    valid[2, :11] = False
    steps = rng.randint(0, 256, (B, 4)).astype(np.int32)
    want = _model_logits(jp, jspec, jt, tokens, valid, steps, jt.init_kv_cache(jspec, B, S))
    got = _model_logits(tp, spec, tt, tokens, valid, steps, tt.init_kv_cache(spec, B, S))
    assert np.isfinite(got).all()
    relative = mode == "int8"
    np.testing.assert_allclose(got[0], want[0], atol=prefill_tol,
                               rtol=prefill_tol if relative else 0)
    np.testing.assert_allclose(got[1:], want[1:], atol=decode_tol,
                               rtol=decode_tol if relative else 0)
    # The greedy choice of every step agrees.
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


# --------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


def _engines(params, mode, **loop):
    jp, tp = params
    kw = dict(model_name=MODEL, max_model_len=2048, quantization=mode, **loop)
    with warnings.catch_warnings():   # int8 without fast-forward warns (tested below)
        warnings.simplefilter("ignore")
        je = JaxEngine(jcfg.EngineConfig(backend="jax", **kw), params=jp)
        te = TorchEngine(tcfg.EngineConfig(backend="torch", **kw), device="cpu", params=tp)
    return je, te


@pytest.mark.parametrize("loop", [{}, dict(decode_fast_forward=True), dict(spec_decode=True)],
                         ids=["plain", "ff", "spec"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_engine_greedy_identical_to_jax(params, mode, loop):
    je, te = _engines(params, mode, **loop)
    assert tq.is_quantized(te.params["layers.0.wq"])
    assert tq.is_int4(te.params["lm_head"]) == (mode == "int4")
    # The donor's f32 tree is untouched: the engine quantized its own copy.
    assert not tq.is_quantized(params[1]["layers.0.wq"])
    a = je.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    b = te.batch_generate_json(PROMPTS, temperature=0.0, max_tokens=64)
    assert b == a
    assert all("error" not in r for r in b)
    assert te.last_decode_steps == je.last_decode_steps
    je.shutdown()
    te.shutdown()


def test_int8_without_fast_forward_warns(params):
    with pytest.warns(UserWarning, match="decode_fast_forward"):
        TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, quantization="int8"),
                    device="cpu", params=params[1])


def test_param_bytes_count_quantized_leaves(params):
    tp = params[1]
    bf = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL), device="cpu",
                     params=tp)
    dense_elems = sum(v.numel() for n, v in tp.items()
                      if n == "lm_head" or n.rsplit(".", 1)[-1] in tq._QUANT_LEAVES)
    other = bf._param_bytes - 4 * dense_elems
    for mode, per_elem in (("int8", 1.0), ("int4", 0.5)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL,
                                                quantization=mode), device="cpu", params=tp)
        scales = sum(t.numel() * t.element_size() for v in eng.params.values()
                     if isinstance(v, dict) for p, t in v.items() if p in ("scale", "gscale"))
        assert eng._param_bytes == other + per_elem * dense_elems + scales
        n_scales = sum(t.numel() for v in eng.params.values() if isinstance(v, dict)
                       for p, t in v.items() if p in ("scale", "gscale"))
        assert tt.param_count(eng.params) == (tt.param_count(tp) + n_scales
                                              - (1 - per_elem) * dense_elems)


# ----------------------------------------------------------------- game

def _config(C, backend):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=2, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048,
                              quantization="int8", kv_cache_dtype="int8",
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


def test_int8_weights_int8_kv_fast_forward_game_identical_to_jax():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    jc, tc = _config(jcfg, "jax"), _config(tcfg, "torch")
    with pytest.warns(UserWarning):
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
    assert tsim.engine.quantization == "int8"


# --------------------------------------------------- sharing and the CLI

def test_shared_params_mode_check():
    """A shared quantized tree must be in the engine's own mode (int8 into
    int4, or any quantized tree under ``quantization=None``, raises); a
    shared bf16 tree is quantized into the engine's own copy."""
    base = tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=512)
    with pytest.warns(UserWarning, match="decode_fast_forward"):
        donor = TorchEngine(dataclasses.replace(base, quantization="int8"), device="cpu")
    assert tq.is_quantized(donor.params["layers.1.w_down"])
    for mode in ("int4", None):
        with pytest.raises(ValueError, match="int8-format"):
            TorchEngine(dataclasses.replace(base, quantization=mode), device="cpu",
                        params=donor.params)
    d4 = TorchEngine(dataclasses.replace(base, quantization="int4"), device="cpu")
    with pytest.raises(ValueError, match="int4-format"):
        TorchEngine(base, device="cpu", params=d4.params)
    same = TorchEngine(dataclasses.replace(base, quantization="int4"), device="cpu",
                       params=d4.params)
    assert same.params["layers.0.wq"] is d4.params["layers.0.wq"]
    assert isinstance(same.generate("hi", max_tokens=4), str)
    bf = TorchEngine(base, device="cpu")
    shared = TorchEngine(dataclasses.replace(base, quantization="int4"), device="cpu",
                         params=bf.params)
    assert tq.is_int4(shared.params["layers.0.wq"])
    assert not tq.is_quantized(bf.params["layers.0.wq"])


def test_cli_takes_quantization(capsys):
    from bcg_tpu_torch.cli import build_parser, config_from_args

    for mode in ("int8", "int4"):
        args = build_parser().parse_args(["--model", "tiny-test", "--device", "cpu",
                                          "--quantization", mode, "--fast-forward"])
        cfg = config_from_args(args)
        assert cfg.engine.quantization == mode and cfg.engine.decode_fast_forward
    assert config_from_args(build_parser().parse_args([])).engine.quantization is None
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--quantization", "nf4"])
    assert "invalid choice" in capsys.readouterr().err
