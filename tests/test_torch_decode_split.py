"""B3a's split-S arithmetic against the JAX package, on the CPU.

The bf16 decode-step kernel (``csrc/decode_attention.cu``) cuts the cache
window into contiguous ranges, one block each, and merges the ranges'
partials (running max, sum of exp, unnormalised accumulator) the way the
JAX package's sequence-parallel decode does.  Its plain version,
``decode_attention_split_plain``, repeats that arithmetic range by range;
here it gets the same seeded numpy inputs as the JAX package's
``decode_attention`` (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) and ``sp_decode_attention`` on an sp mesh of
2, 4 and 8 CPU devices, where each device holds one range of the cache.
``decode_split_plan``, the pure function that sizes the kernel's grid, is
tested beside it.

Tolerances: f32 inputs 1e-4 (the same math in another summation order:
per-range maxima and sums merged, against the Pallas kernel's 128-slot
blocks or the sp merge); bf16 inputs 2e-2, the port's bf16 attention
tolerance (each side rounds p to bf16 relative to another running max and
rounds its bf16 output).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.ops.decode_attention import decode_attention as j_decode_attention
from bcg_tpu.ops.ring_attention import sp_decode_attention
from bcg_tpu.parallel import build_mesh
from bcg_tpu_torch.ops.decode_attention import (
    SPLIT_ITER, decode_attention_plain, decode_attention_split_plain, decode_split_plan)
import _torch_jax_obs_state

TOL = {"f32": 1e-4, "bf16": 2e-2}
GROUPS = [(4, 4), (4, 2), (8, 2), (10, 2), (16, 2)]
GROUP_IDS = ["g1", "g2", "g4", "g5", "g8"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs several
    workers on one machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


def _inputs(seed, B, S, H, Hkv, Dh=128):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    return rng, q, k, v


def _t(x, dt):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _j(x, dt):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dt == "bf16" else a


def _jax_decode(q, k, v, m, scale, dt):
    """The JAX package's decode step (Pallas kernel, interpret mode) as f32
    numpy; a per-row mask [B, G, S] runs one call per member g of every
    kv head's group (query heads hk * G + g, each with its own mask row)."""
    if m.ndim == 2:
        out = j_decode_attention(_j(q, dt), _j(k, dt), _j(v, dt), jnp.asarray(m), scale,
                                 block_s=128, interpret=True)
        return np.asarray(out.astype(jnp.float32))
    B, H, Dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh)
    outs = []
    for g in range(G):
        o = j_decode_attention(_j(qg[:, :, g], dt), _j(k, dt), _j(v, dt), jnp.asarray(m[:, g]),
                               scale, block_s=128, interpret=True)
        outs.append(np.asarray(o.astype(jnp.float32)))
    return np.stack(outs, axis=2).reshape(B, H, Dh)


_REF = {}


def _case(H, Hkv, dt, per_row):
    """Inputs and the JAX reference of one (group, dtype, mask form),
    computed once for every split count."""
    key = (H, Hkv, dt, per_row)
    if key not in _REF:
        B, S = 3, 300
        rng, q, k, v = _inputs([H, Hkv, int(per_row)], B, S, H, Hkv)
        shape = (B, H // Hkv, S) if per_row else (B, S)
        m = rng.random(shape) < 0.5
        m[1] = False
        m[1, ..., :40] = rng.random(m[1, ..., :40].shape) < 0.7   # live only in the first split
        m[2] = False                                               # a fully masked row
        scale = 1.0 / np.sqrt(128)
        _REF[key] = (q, k, v, m, scale, _jax_decode(q, k, v, m, scale, dt))
    return _REF[key]


@pytest.mark.parametrize("n_split", [1, 2, 3, 7])
@pytest.mark.parametrize("per_row", [False, True], ids=["shared-mask", "per-row-mask"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv", GROUPS, ids=GROUP_IDS)
def test_split_plain_matches_jax_decode_attention(H, Hkv, dt, per_row, n_split):
    q, k, v, m, scale, ref = _case(H, Hkv, dt, per_row)
    out = decode_attention_split_plain(_t(q, dt), _t(k, dt), _t(v, dt), torch.from_numpy(m),
                                       scale, n_split)
    np.testing.assert_allclose(out.float().numpy(), ref, atol=TOL[dt], rtol=TOL[dt])
    assert np.all(out[2].float().numpy() == 0.0)      # every split empty: 0, not NaN


@pytest.mark.parametrize("n_split,split_len", [(3, SPLIT_ITER), (2, 256), (7, 43)],
                         ids=["kernel-iterations", "long-last", "short-last"])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (10, 2)], ids=["g4", "g5"])
def test_split_lengths_match_one_split(H, Hkv, n_split, split_len):
    """Ranges of the kernel's own length (the last range shorter or
    longer than the others) give the single-range result (f32)."""
    q, k, v, m, scale, ref = _case(H, Hkv, "f32", False)
    S = k.shape[1]
    out = decode_attention_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(m), scale,
                                       n_split, split_len)
    one = decode_attention_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(m), scale, 1)
    assert (n_split - 1) * split_len < S
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["f32"], rtol=TOL["f32"])


@pytest.mark.parametrize("H,Hkv", GROUPS, ids=GROUP_IDS)
def test_split_plain_equals_plain_decode_in_bf16(H, Hkv):
    """The split version and the one-shot plain version (what the CPU
    wrapper runs) agree at the bf16 tolerance, per-row mask included."""
    q, k, v, m, scale, _ = _case(H, Hkv, "bf16", True)
    args = (_t(q, "bf16"), _t(k, "bf16"), _t(v, "bf16"), torch.from_numpy(m), scale)
    split = decode_attention_split_plain(*args, 3)
    whole = decode_attention_plain(*args)
    torch.testing.assert_close(split.float(), whole.float(), atol=TOL["bf16"], rtol=TOL["bf16"])


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 2), (10, 2)], ids=["g1", "g4", "g5"])
def test_split_plain_matches_sp_decode_attention(H, Hkv, dt, sp):
    """One range per sp device, the JAX package's flash-decoding merge."""
    B, S = 3, 304
    rng, q, k, v = _inputs([sp, H, Hkv, 7], B, S, H, Hkv)
    m = np.stack([np.ones(S, bool), np.arange(S) < 6,
                  (np.arange(S) % 3 == 0) & (np.arange(S) < 200)])
    scale = 1.0 / np.sqrt(128)
    mesh = build_mesh(dp=1, tp=1, sp=sp)
    ref = sp_decode_attention(_j(q, dt), _j(k, dt), _j(v, dt), jnp.asarray(m), mesh, scale=scale)
    out = decode_attention_split_plain(_t(q, dt), _t(k, dt), _t(v, dt), torch.from_numpy(m),
                                       scale, sp, S // sp)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("n_split", [2, 8])
def test_strongly_negative_logits_survive_empty_splits(n_split):
    """Every live logit near -100 and live slots only in the last range:
    the empty ranges weigh exactly 0 (with the -1e30 sentinel an empty
    range's own weight would be exp(0) = 1), so the result is the true
    softmax average, as sp_decode_attention and the Pallas kernel give."""
    B, S, H, Hkv, Dh = 2, 64, 4, 2, 128
    scale = 1.0 / np.sqrt(Dh)
    q = np.full((B, H, Dh), 5.0, np.float32)
    k = np.full((B, S, Hkv, Dh), -20.0 / np.sqrt(Dh), np.float32)   # q.k * scale = -100
    v = np.random.default_rng(11).standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    m = np.arange(S)[None, :] >= np.array([56, 62])[:, None]
    out = decode_attention_split_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), torch.from_numpy(m), scale, n_split,
                                       S // n_split)
    mesh = build_mesh(dp=1, tp=1, sp=n_split)
    sp_ref = np.asarray(sp_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            jnp.asarray(m), mesh, scale=scale))
    pallas_ref = _jax_decode(q, k, v, m, scale, "f32")
    assert np.abs(out.numpy()).max() > 0.1
    np.testing.assert_allclose(out.numpy(), sp_ref, atol=TOL["f32"], rtol=TOL["f32"])
    np.testing.assert_allclose(out.numpy(), pallas_ref, atol=TOL["f32"], rtol=TOL["f32"])


# ---------------------------------------------------------------- the plan

def _ranges(S, n, per):
    return [(z * per, S if z == n - 1 else (z + 1) * per) for z in range(n)]


@pytest.mark.parametrize("B,Hkv,S,sms,occ", [
    (10, 8, 5065, 132, 3), (10, 8, 5065, 132, 2), (1, 8, 8191, 132, 3),
    (1, 8, 8191, 132, 2), (3, 2, 1000, 132, 3), (2, 2, 129, 132, 3), (1, 1, 1, 132, 3),
    (1, 1, 127, 4, 2), (1, 1, 300, 4, 2), (4, 2, 70000, 132, 3), (33, 8, 5000, 132, 3),
    (34, 8, 5000, 132, 3), (40, 8, 100, 132, 3)])
def test_split_plan_covers_the_window(B, Hkv, S, sms, occ):
    n, per = decode_split_plan(B, Hkv, S, sms, occ)
    assert n >= 1 and per > 0 and per % SPLIT_ITER == 0
    ranges = _ranges(S, n, per)
    # Contiguous, in order, exactly [0, S): no empty range and none
    # shorter than one iteration (unless S itself is).
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e - a >= min(S, SPLIT_ITER) for a, e in ranges)
    # Never more blocks than a wave of max(2, occ) per SM, never more
    # splits than iterations.
    assert n <= -(-S // SPLIT_ITER)
    if n > 1:
        assert B * Hkv * n <= max(2, occ) * sms


@pytest.mark.parametrize("B,Hkv", [(33, 8), (66, 4), (264, 1), (100, 8)])
def test_split_plan_is_one_split_when_the_pairs_fill_the_card(B, Hkv):
    assert B * Hkv >= 2 * 132
    assert decode_split_plan(B, Hkv, 5065, 132, 3)[0] == 1


def test_split_plan_at_the_bench_shape():
    """bench-8b's game decode (B 10, 8 kv heads, S ~5065 on 132 SMs):
    80 pairs need several splits to give every SM two or more blocks."""
    n, per = decode_split_plan(10, 8, 5065, 132, 3)
    assert (n, per) == (4, 1280)
    assert 10 * 8 * n >= 2 * 132
    assert decode_split_plan(10, 8, 5065, 132, 2) == (3, 1792)
    assert decode_split_plan(1, 1, 5, 132, 3) == (1, SPLIT_ITER)
