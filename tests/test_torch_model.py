"""Model-level parity: ``bcg_tpu_torch.models.transformer`` against
``bcg_tpu.models.transformer`` on the same weights (JAX ``init_params``
-> numpy -> ``params_from_numpy``) and the same seeded token batches.

Tolerances on the f32 logits:

* f32 weights, prefill: 1e-4.  Both sides compute in f32; only the
  summation order differs.
* f32 weights, decode steps: 1e-2.  The KV cache is bf16 on both
  sides, and both round the decode step's attention probabilities and
  output to it (the JAX package's ``probs.astype(v.dtype)``).  Summed in
  another order, a value now and then lands on the other side of a bf16
  rounding boundary: one ulp (2**-8 relative) moves that row's logits by
  up to ~1e-3, and a flipped cache entry carries into later steps
  (measured: 6e-4 in one step on a shared cache, 4.2e-3 over eight steps
  on ``tiny-dh128``; 2e-6 wherever no rounding flips).  1e-2 stays below
  one bf16 ulp of these logits (magnitude ~4, ulp 1.6e-2).
* bf16 weights: 6e-2 absolute on logits of magnitude ~3 (the JAX plain
  attention rounds raw q.k scores to bf16, the port's kernel-precision
  path keeps them in f32, and every bf16 matmul rounds its output — a
  few bf16 ulps after two layers).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import RopeScaling as JRopeScaling
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import RopeScaling, spec_for_model
from bcg_tpu_torch.models.convert import init_params, params_from_numpy


def named_arrays(tree):
    """The JAX param tree by ``param_plan`` logical name (list or
    stacked ``scan_layers`` form)."""
    out = []
    for k, v in tree.items():
        if k != "layers":
            out.append((k, np.asarray(v)))
        elif isinstance(v, dict):
            out += [(f"layers.{n}", np.asarray(a)) for n, a in v.items()]
        else:
            out += [(f"layers.{i}.{n}", np.asarray(a)) for i, l in enumerate(v)
                    for n, a in l.items()]
    return out


# tiny-test with every optional param_plan leaf flipped: Qwen2-style
# projection biases (set to random values below, not the init's zeros),
# tied embeddings, no qk-norm, and llama3 rope scaling.  No preset has
# them at a tiny size.
VARIANT = "tiny-bias-tied-llama3"

CASES = [
    pytest.param("bcg-tpu/tiny-test", jnp.float32, 1e-4, id="tiny-f32"),
    pytest.param("bcg-tpu/tiny-dh128", jnp.float32, 1e-4, id="dh128-f32"),
    pytest.param(VARIANT, jnp.float32, 1e-4, id="bias-tied-llama3-f32"),
    pytest.param("bcg-tpu/tiny-test", jnp.bfloat16, 6e-2, id="tiny-bf16"),
]
# Decode steps read the bf16 cache (see the module docstring).
DECODE_TOL_F32 = 1e-2


def _specs(model):
    if model != VARIANT:
        return j_spec(model), spec_for_model(model)
    kw = dict(name=VARIANT, qk_norm=False, attn_bias=True, tie_embeddings=True)
    return (dataclasses.replace(j_spec("bcg-tpu/tiny-test"), rope_scaling=JRopeScaling(), **kw),
            dataclasses.replace(spec_for_model("bcg-tpu/tiny-test"), rope_scaling=RopeScaling(),
                                **kw))


def _setup(model, jdtype, seed=0):
    jspec, spec = _specs(model)
    jp = jt.init_params(jspec, jax.random.PRNGKey(seed), dtype=jdtype)
    if spec.attn_bias:
        rng = np.random.RandomState(seed)
        for layer in jp["layers"]:
            for n in ("bq", "bk", "bv"):
                layer[n] = jnp.asarray(rng.standard_normal(layer[n].shape) * 0.5, jdtype)
    tdtype = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", tdtype)
    return jspec, spec, jp, tp


def _batch(rng, B, L, vocab=256):
    tokens = rng.randint(0, vocab, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    for b in range(1, B):
        valid[b, : rng.randint(1, L // 2)] = False
    return tokens, valid


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("model,jdtype,tol", CASES)
def test_prefill_and_eight_decode_steps(model, jdtype, tol):
    jspec, spec, jp, tp = _setup(model, jdtype)
    rng = np.random.RandomState(1)
    B, L, S = 3, 40, 56
    tokens, valid = _batch(rng, B, L)
    jl, jc = jt.prefill(jp, jspec, jnp.asarray(tokens), jnp.asarray(valid),
                        jt.init_kv_cache(jspec, B, S))
    tc = tt.init_kv_cache(spec, B, S)
    tl, tc = tt.prefill(tp, spec, torch.from_numpy(tokens).long(),
                        torch.from_numpy(valid), tc)
    _close(tl, jl, tol)
    vm = np.zeros((B, S), bool)
    vm[:, :L] = valid
    lens = valid.sum(1).astype(np.int32)
    steps = rng.randint(0, 256, (8, B)).astype(np.int32)
    for i in range(8):
        vm[:, L + i] = True
        jl, jc = jt.decode_step(jp, jspec, jnp.asarray(steps[i]), jnp.int32(L + i),
                                jnp.asarray(lens + i), jc, jnp.asarray(vm))
        tl, tc = tt.decode_step(tp, spec, torch.from_numpy(steps[i]).long(), L + i,
                                torch.from_numpy(lens + i), tc, torch.from_numpy(vm))
        _close(tl, jl, max(tol, DECODE_TOL_F32))
    # The cache was written in place with the same bf16 values.
    _close(tc[0]["k"].float().numpy(), np.asarray(jc[0]["k"], np.float32), max(tol, 1e-2))


@pytest.mark.parametrize("model,jdtype,tol", CASES)
def test_prefix_then_suffix_prefill(model, jdtype, tol):
    jspec, spec, jp, tp = _setup(model, jdtype, seed=3)
    rng = np.random.RandomState(2)
    B, P, Ls, tail = 2, 32, 24, 8
    ptok, pvalid = _batch(rng, 1, P)
    stok, svalid = _batch(rng, B, Ls)
    # Prefix entry (B=1), then the batch cache with the prefix in [0, P).
    _, jpc = jt.prefill(jp, jspec, jnp.asarray(ptok), jnp.asarray(pvalid),
                        jt.init_kv_cache(jspec, 1, P))
    tpc = tt.init_kv_cache(spec, 1, P)
    _, tpc = tt.prefill(tp, spec, torch.from_numpy(ptok).long(), torch.from_numpy(pvalid), tpc)
    S = P + Ls + tail
    jcache = [{n: jnp.concatenate([jnp.repeat(e[n], B, 0),
                                   jnp.zeros((B, S - P) + e[n].shape[2:], e[n].dtype)], 1)
               for n in ("k", "v")} for e in jpc]
    tcache = tt.init_kv_cache(spec, B, S)
    tcache.buf[:, :, :, :P] = tpc.buf
    prefix_valid = np.repeat(pvalid, B, 0)
    plens = prefix_valid.sum(1).astype(np.int32)
    jl, _ = jt.prefill_with_prefix(jp, jspec, jnp.asarray(stok), jnp.asarray(svalid), jcache,
                                   jnp.asarray(prefix_valid), jnp.asarray(plens))
    tl, _ = tt.prefill_with_prefix(tp, spec, torch.from_numpy(stok).long(),
                                   torch.from_numpy(svalid), tcache,
                                   torch.from_numpy(prefix_valid), torch.from_numpy(plens))
    _close(tl, jl, tol)


@pytest.mark.parametrize("model,jdtype,tol", CASES[:2])
def test_prefill_chunk_at_matches_jax(model, jdtype, tol):
    """Chunked prefill (a fixed history window read from the bf16 cache,
    a moving write slot): every chunk's logits and the cache it leaves
    match the JAX package's ``prefill_chunk_at``."""
    jspec, spec, jp, tp = _setup(model, jdtype, seed=4)
    rng = np.random.RandomState(3)
    B, L, C = 2, 24, 8
    tokens, valid = _batch(rng, B, L)
    H = L - C
    jc = jt.init_kv_cache(jspec, B, L)
    tc = tt.init_kv_cache(spec, B, L)
    for start in range(0, L, C):
        hist = np.zeros((B, H), bool)
        hist[:, :start] = valid[:, :start]
        off = valid[:, :start].sum(1).astype(np.int32)
        jl, jc = jt.prefill_chunk_at(jp, jspec, jnp.asarray(tokens[:, start:start + C]),
                                     jnp.asarray(valid[:, start:start + C]), jc,
                                     jnp.asarray(hist), jnp.asarray(off), jnp.int32(start))
        tl, tc = tt.prefill_chunk_at(tp, spec, torch.from_numpy(tokens[:, start:start + C]).long(),
                                     torch.from_numpy(valid[:, start:start + C]), tc,
                                     torch.from_numpy(hist), torch.from_numpy(off), start)
        _close(tl, jl, tol)
    # The cache at real-token slots (a left-pad query row attends to
    # nothing: the port's kernel semantics give it 0 where the JAX plain
    # attention averages, so pad slots' KV differs in later layers and is
    # never read).
    for li in range(spec.num_layers):
        _close(tc[li]["v"].float().numpy()[valid], np.asarray(jc[li]["v"], np.float32)[valid],
               1e-2)


def test_params_from_numpy_stacked_form_and_validation():
    model = "bcg-tpu/tiny-test"
    jspec, spec = j_spec(model), spec_for_model(model)
    jp = jt.init_params(jspec, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    flat = params_from_numpy(named_arrays(jp), spec)
    stacked = params_from_numpy(named_arrays(jt.stack_layer_params(jp)), spec)
    assert flat.keys() == stacked.keys() == {n for n, _, _ in tt.param_plan(spec)}
    for n in flat:
        assert flat[n].dtype == torch.bfloat16
        assert torch.equal(flat[n], stacked[n]), n
    # bf16 payload reinterpretation is exact.
    assert np.array_equal(flat["embed"].float().numpy(),
                          np.asarray(jp["embed"], np.float32))
    arrays = named_arrays(jp)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy(arrays[1:], spec)
    bad = [(n, a[:1] if n == "embed" else a) for n, a in arrays]
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(bad, spec)


def test_param_plan_matches_jax_and_init_distribution():
    for model in ("bcg-tpu/tiny-test", "bcg-tpu/bench-8b"):
        assert tt.param_plan(spec_for_model(model)) == jt.param_plan(j_spec(model))
    spec = spec_for_model("bcg-tpu/tiny-dh128")
    p = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    w = p["layers.0.w_gate"].float()
    assert p["layers.0.w_gate"].dtype == torch.bfloat16
    # N(0, 1) / sqrt(fan_in): std ~ 1/16 for fan_in 256.
    assert abs(w.std().item() * 16 - 1.0) < 0.05
    assert torch.all(p["final_norm"] == 1) and torch.all(p["layers.1.q_norm"] == 1)
