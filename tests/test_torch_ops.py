"""Op-level parity of the PyTorch port against the JAX package.

The port's plain versions (what its kernel wrappers run on CPU tensors)
get the same seeded numpy inputs as the JAX package's Pallas kernels,
run in interpret mode exactly as the JAX package's own tests run them.
Tolerances: f32 inputs 1e-5 (the same math in the same precision; only
the summation order differs — online vs one-shot softmax); bf16 inputs
2e-2 (both sides round probabilities to bf16, at different points: the
Pallas kernel rounds unnormalised p, the plain version normalised p, and
each rounds its bf16 output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import RopeScaling as JRopeScaling
from bcg_tpu.ops import attention as jattn
from bcg_tpu.ops.decode_attention import decode_attention as j_decode_attention
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import RopeScaling
from bcg_tpu_torch.ops.attention import flash_attention, flash_attention_plain
from bcg_tpu_torch.ops.decode_attention import decode_attention, decode_attention_plain

TOL = {np.float32: 1e-5, "bf16": 2e-2}


def _arr(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return x


def _to_jax(x, bf16):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if bf16 else a


def _to_torch(x, bf16):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if bf16 else t


def _mask(rng, kind, B, T, S):
    """[B, T, S] bool masks: random; left-padded suffix over a cached
    prefix (prefill_with_prefix's construction); and the same with fully
    masked query rows (left-pad queries)."""
    if kind == "random":
        m = rng.random((B, T, S)) < 0.6
        m[:, :, 0] = True
        return m
    P = S - T
    prefix_valid = np.zeros((B, P), bool)
    suffix_valid = np.zeros((B, T), bool)
    for b in range(B):
        prefix_valid[b, rng.integers(0, max(P // 2, 1)):] = True
        suffix_valid[b, rng.integers(0, T // 2 + 1):] = True
    causal = np.tril(np.ones((T, T), bool))
    chunk = causal[None] & suffix_valid[:, None, :] & suffix_valid[:, :, None]
    hist = prefix_valid[:, None, :] & suffix_valid[:, :, None]
    m = np.concatenate([hist, chunk], axis=2)
    if kind == "prefix":
        # keep every query row live so only real rows are compared
        m[:, :, 0] |= True
    return m


def _jax_flash_interpret(q, k, v, mask, scale, block_q=128, block_kv=128):
    """flash_attention's padding + transposes around _pallas_flash, with
    interpret=True (the JAX package's own interpret-mode test path)."""
    B, T, H, Dh = q.shape
    qt = jattn._pad_to(q.transpose(0, 2, 1, 3), 2, block_q)
    kt = jattn._pad_to(k.transpose(0, 2, 1, 3), 2, block_kv)
    vt = jattn._pad_to(v.transpose(0, 2, 1, 3), 2, block_kv)
    mp = jattn._pad_to(jattn._pad_to(mask, 1, block_q), 2, block_kv)
    out = jattn._pallas_flash(qt, kt, vt, mp, scale, block_q, block_kv, interpret=True)
    return out[:, :, :T].transpose(0, 2, 1, 3)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["random", "prefix", "padrows"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (4, 1)], ids=["g1", "g2", "g4"])
def test_flash_plain_matches_pallas_kernel(H, Hkv, mask_kind, bf16):
    rng = np.random.default_rng([H, Hkv, len(mask_kind)])
    B, T, S, Dh = 2, 150, 260, 128      # ragged T and S (pads in both)
    q = _arr(rng, (B, T, H, Dh), None)
    k = _arr(rng, (B, S, Hkv, Dh), None)
    v = _arr(rng, (B, S, Hkv, Dh), None)
    m = _mask(rng, mask_kind, B, T, S)
    scale = 1.0 / np.sqrt(Dh)
    ref = _jax_flash_interpret(_to_jax(q, bf16), _to_jax(k, bf16), _to_jax(v, bf16),
                               jnp.asarray(m), scale)
    out = flash_attention(_to_torch(q, bf16), _to_torch(k, bf16), _to_torch(v, bf16),
                          torch.from_numpy(m), scale)
    ref = np.asarray(ref.astype(jnp.float32))
    out = out.float().numpy()
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    dead = ~m.any(axis=2)
    if dead.any():   # fully masked query rows give exactly 0, never NaN
        assert np.all(out[dead] == 0.0)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("mask_kind", ["prefix", "random"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)], ids=["g1", "g2", "g4"])
def test_decode_plain_matches_pallas_kernel(H, Hkv, mask_kind, bf16):
    rng = np.random.default_rng([H, Hkv, len(mask_kind), 1])
    B, S, Dh = 3, 300, 128              # ragged S
    q = _arr(rng, (B, H, Dh), None)
    k = _arr(rng, (B, S, Hkv, Dh), None)
    v = _arr(rng, (B, S, Hkv, Dh), None)
    if mask_kind == "prefix":
        m = np.zeros((B, S), bool)
        for b in range(B):
            m[b, rng.integers(0, 100):rng.integers(150, S)] = True
    else:
        m = rng.random((B, S)) < 0.5
    m[2] = False   # a fully masked row gives 0
    scale = 1.0 / np.sqrt(Dh)
    ref = j_decode_attention(_to_jax(q, bf16), _to_jax(k, bf16), _to_jax(v, bf16),
                             jnp.asarray(m), scale, block_s=128, interpret=True)
    out = decode_attention(_to_torch(q, bf16), _to_torch(k, bf16), _to_torch(v, bf16),
                           torch.from_numpy(m), scale)
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    assert np.all(out[2].float().numpy() == 0.0)


def test_decode_plain_per_row_mask_matches_shared_mask():
    """The [B, G, S] mask form (one row per query head of a kv head)
    reduces to the shared [B, S] form when every row is equal."""
    rng = np.random.default_rng(5)
    B, S, H, Hkv, Dh = 2, 64, 4, 2, 128
    q = torch.from_numpy(_arr(rng, (B, H, Dh), None))
    k = torch.from_numpy(_arr(rng, (B, S, Hkv, Dh), None))
    v = torch.from_numpy(_arr(rng, (B, S, Hkv, Dh), None))
    m = torch.from_numpy(rng.random((B, S)) < 0.7)
    shared = decode_attention_plain(q, k, v, m, 0.1)
    per_row = decode_attention_plain(q, k, v, m[:, None, :].expand(B, 2, S), 0.1)
    torch.testing.assert_close(per_row, shared, atol=1e-6, rtol=1e-6)


def test_flash_plain_equals_xla_attention_in_f32():
    rng = np.random.default_rng(9)
    q = torch.from_numpy(_arr(rng, (2, 7, 4, 16), None))
    k = torch.from_numpy(_arr(rng, (2, 11, 2, 16), None))
    v = torch.from_numpy(_arr(rng, (2, 11, 2, 16), None))
    m = torch.from_numpy(rng.random((2, 7, 11)) < 0.6)
    torch.testing.assert_close(flash_attention_plain(q, k, v, m, 0.25),
                               tt._xla_attention(q, k, v, m, 0.25), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_xla_attention_matches_jax(bf16):
    rng = np.random.default_rng(11)
    B, T, S, H, Hkv, Dh = 2, 9, 13, 4, 2, 16
    q, k, v = (_arr(rng, s, None) for s in [(B, T, H, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)])
    m = rng.random((B, T, S)) < 0.6
    ref = jt._xla_attention(_to_jax(q, bf16), _to_jax(k, bf16), _to_jax(v, bf16),
                            jnp.asarray(m), 0.3)
    out = tt._xla_attention(_to_torch(q, bf16), _to_torch(k, bf16), _to_torch(v, bf16),
                            torch.from_numpy(m), 0.3)
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_rms_norm_matches_jax(bf16):
    rng = np.random.default_rng(1)
    x = _arr(rng, (3, 5, 64), None) * 3
    w = 1 + 0.1 * _arr(rng, (64,), None)
    ref = jt.rms_norm(_to_jax(x, bf16), _to_jax(w, bf16), 1e-6)
    out = tt.rms_norm(_to_torch(x, bf16), _to_torch(w, bf16), 1e-6)
    tol = TOL["bf16" if bf16 else np.float32]
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("scaled", [False, True], ids=["plain", "llama3"])
def test_rope_matches_jax(scaled):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 9000, (2, 6)).astype(np.int32)
    kw_j = dict(scaling=JRopeScaling()) if scaled else {}
    kw_t = dict(scaling=RopeScaling()) if scaled else {}
    theta = 500_000.0 if scaled else 1_000_000.0
    cj, sj = jt.rope_table(jnp.asarray(pos), 128, theta, **kw_j)
    ct, st = tt.rope_table(torch.from_numpy(pos), 128, theta, **kw_t)
    # Angles reach ~9000 rad: an ulp of the f32 angle is ~5e-4, so the
    # cos/sin of equal-but-independently-rounded angles agree to ~1e-3.
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-3, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-3, rtol=0)
    x = _arr(rng, (2, 6, 4, 128), None)
    small = (pos % 64).astype(np.int32)   # small angles: f32-exact comparison
    cj, sj = jt.rope_table(jnp.asarray(small), 128, theta, **kw_j)
    ct, st = tt.rope_table(torch.from_numpy(small), 128, theta, **kw_t)
    ref = jt.apply_rope(jnp.asarray(x), cj, sj)
    out = tt.apply_rope(torch.from_numpy(x), ct, st)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_kernel_wrappers_raise_on_cuda_inputs_they_do_not_take():
    """On a CUDA tensor the wrappers launch or raise; the shape/type
    checks run before any build, so they are testable without a card."""
    from bcg_tpu_torch.ops import attention as ta, decode_attention as td

    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim 128"):
        ta._check(q, torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16),
                  torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16),
                  torch.ones((1, 4, 4), dtype=torch.bool))
    q = torch.zeros((1, 4, 2, 128), dtype=torch.float32)
    kv = torch.zeros((1, 4, 1, 128), dtype=torch.float32)
    with pytest.raises(TypeError, match="bf16"):
        ta._check(q, kv, kv, torch.ones((1, 4, 4), dtype=torch.bool))
    qd = torch.zeros((1, 18, 128), dtype=torch.bfloat16)
    kvd = torch.zeros((1, 8, 2, 128), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="groups up to"):
        td._check(qd, kvd, kvd, torch.ones((1, 1, 8), dtype=torch.bool))
