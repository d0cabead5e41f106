"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built from
``bcg_tpu_torch/csrc`` at first use) and skips without them.  This module
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covered: flash prefill, bf16 decode attention (single step and chunk),
int8 decode attention (single step and chunk, at the bench-8b shapes
and at a GQA group of 5) and the guided sampler.

Tolerances: bf16 attention 2e-2 absolute on outputs of magnitude ~1-4.
The kernels round the unnormalised probabilities to bf16 for the p.v
product (as the Pallas kernels do), the plain versions the normalised
ones, and each rounds its bf16 output: a few bf16 ulps (2**-8 relative).
The sampler is compared token for token, with no tolerance.
"""

import numpy as np
import pytest
import torch

from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler

pytestmark = pytest.mark.requires_cuda

TOL = 2e-2


@pytest.fixture
def dev():
    """Decided per test, never at import: without a card the test skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc and run only there")
    return torch.device("cuda")


def _prefix_mask(rng, B, T, S, dead_rows):
    """prefill_with_prefix's mask: a left-padded suffix (causal) over a
    left-padded cached prefix; ``dead_rows`` keeps pad query rows fully
    masked."""
    P = S - T
    pv = np.zeros((B, P), bool)
    sv = np.zeros((B, T), bool)
    for b in range(B):
        pv[b, rng.integers(0, max(P // 2, 1)):] = True
        sv[b, rng.integers(0, T // 2 + 1):] = True
    chunk = np.tril(np.ones((T, T), bool))[None] & sv[:, None, :] & sv[:, :, None]
    m = np.concatenate([pv[:, None, :] & sv[:, :, None], chunk], axis=2)
    if not dead_rows:
        m[:, :, 0] = True
    return m


@pytest.mark.parametrize("mask_kind", ["random", "prefix", "padrows"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 4), (32, 8)], ids=["g1", "g2", "g4"])
def test_flash_kernel_matches_plain(dev, H, Hkv, mask_kind):
    rng = np.random.default_rng([H, Hkv, len(mask_kind)])
    B, T, S, Dh = 2, 150, 470, 128       # ragged T and S: partial tiles
    if mask_kind == "random":
        m = rng.random((B, T, S)) < 0.5
    else:
        m = _prefix_mask(rng, B, T, S, dead_rows=mask_kind == "padrows")
    q = torch.from_numpy(rng.standard_normal((B, T, H, Dh), np.float32)).to(dev, torch.bfloat16)
    # k/v as strided views of one cache buffer, as the engine passes them.
    cache = torch.from_numpy(rng.standard_normal((B, S + 9, 2, Hkv, Dh), np.float32))
    cache = cache.to(dev, torch.bfloat16)
    k, v = cache[:, :S, 0], cache[:, :S, 1]
    mask = torch.from_numpy(m).to(dev)
    before = attention.flash_attention.launches
    out = attention.flash_attention(q, k, v, mask, Dh ** -0.5)
    torch.cuda.synchronize()
    assert attention.flash_attention.launches == before + 1
    ref = attention.flash_attention_plain(q, k, v, mask, Dh ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    dead = ~mask.any(dim=2)
    assert torch.all(out[dead] == 0)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared-mask", "per-row-mask"])
@pytest.mark.parametrize("H,Hkv", [(4, 4), (32, 8), (16, 2)], ids=["g1", "g4", "g8"])
def test_decode_kernel_matches_plain(dev, H, Hkv, per_row):
    rng = np.random.default_rng([H, Hkv, int(per_row)])
    B, S, Dh = 3, 1000, 128
    group = H // Hkv
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32)).to(dev, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal((2, B, S + 5, Hkv, Dh), np.float32))
    cache = cache.to(dev, torch.bfloat16)
    k, v = cache[0, :, :S], cache[1, :, :S]
    shape = (B, group, S) if per_row else (B, S)
    m = rng.random(shape) < 0.6
    m[2] = False                                  # a fully masked row gives 0
    mask = torch.from_numpy(m).to(dev)
    before = decode_attention.decode_attention.launches
    out = decode_attention.decode_attention(q, k, v, mask, Dh ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches == before + 1
    ref = decode_attention.decode_attention_plain(q, k, v, mask, Dh ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    assert torch.all(out[2] == 0)


def _cache_views(rng, dev, B, S, Hkv, Dh, int8):
    """k/v as views of one cache buffer, as the engine passes them: bf16
    [B, S, Hkv, Dh] strided over (k, v) pairs, or int8 [B, Hkv, S, Dh]
    with f32 scales [B, Hkv, S] (from ``quantize_kv`` of random K/V)."""
    x = torch.from_numpy(rng.standard_normal((B, S + 7, 2, Hkv, Dh), np.float32))
    if not int8:
        cache = x.to(dev, torch.bfloat16)
        return cache[:, :S, 0], cache[:, :S, 1], None, None
    q8, sc = decode_attention.quantize_kv(x.to(dev))          # [B, S+7, 2, Hkv, ...]
    buf = q8.permute(2, 0, 3, 1, 4).contiguous()               # [2, B, Hkv, S+7, Dh]
    scales = sc.permute(2, 0, 3, 1).contiguous()               # [2, B, Hkv, S+7]
    return buf[0, :, :, :S], buf[1, :, :, :S], scales[0, :, :, :S], scales[1, :, :, :S]


# bench-8b (32 / 8 heads): fast-forward chunks of 4, speculative verify
# chunks of 5; a group of 5 (40 / 8 heads, rows 20 and 25).
CHUNK_SHAPES = [(32, 8, 4), (32, 8, 5), (40, 8, 4), (40, 8, 5)]
CHUNK_IDS = ["bench-ff", "bench-spec", "g5-ff", "g5-spec"]


@pytest.mark.parametrize("H,Hkv,K", CHUNK_SHAPES, ids=CHUNK_IDS)
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_chunk_kernels_match_plain(dev, H, Hkv, K, int8):
    rng = np.random.default_rng([H, Hkv, K, int(int8)])
    B, S, Dh = 10, 1500, 128
    k, v, ks, vs = _cache_views(rng, dev, B, S, Hkv, Dh, int8)
    q = torch.from_numpy(rng.standard_normal((B, K, H, Dh), np.float32)).to(dev, torch.bfloat16)
    m = rng.random((B, K, S)) < 0.6
    m[2, 1] = False                               # a fully masked chunk row gives 0
    m[3] = False
    m[3, :, 700:760] = True                       # a row whose keys all sit in one tile
    mask = torch.from_numpy(m).to(dev)
    if int8:
        fn, plain = decode_attention.chunk_decode_attention_int8, \
            decode_attention.chunk_decode_attention_int8_plain
        args = (q, k, v, ks, vs, mask, Dh ** -0.5)
    else:
        fn, plain = decode_attention.chunk_decode_attention, \
            decode_attention.chunk_decode_attention_plain
        args = (q, k, v, mask, Dh ** -0.5)
    before = fn.launches
    out = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    torch.testing.assert_close(out.float(), plain(*args).float(), atol=TOL, rtol=TOL)
    assert torch.all(out[2, 1] == 0)


@pytest.mark.parametrize("H,Hkv", [(32, 8), (40, 8), (16, 2)], ids=["bench", "g5", "g8"])
def test_int8_decode_kernel_matches_plain(dev, H, Hkv):
    rng = np.random.default_rng([H, Hkv, 8])
    B, S, Dh = 10, 3000, 128
    k, v, ks, vs = _cache_views(rng, dev, B, S, Hkv, Dh, int8=True)
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32)).to(dev, torch.bfloat16)
    m = rng.random((B, S)) < 0.6
    m[2] = False
    mask = torch.from_numpy(m).to(dev)
    before = decode_attention.decode_attention_int8.launches
    out = decode_attention.decode_attention_int8(q, k, v, ks, vs, mask, Dh ** -0.5)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention_int8.launches == before + 1
    ref = decode_attention.decode_attention_int8_plain(q, k, v, ks, vs, mask, Dh ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    assert torch.all(out[2] == 0)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("V", [151936, 300], ids=["qwen-vocab", "offlane-v300"])
def test_sampler_kernel_matches_plain(dev, V, top_p):
    rng = np.random.default_rng([V, int(top_p * 10)])
    B, n_dfa, n_states, eos = 8, 2, 5, 3
    minb = rng.integers(1, 6, (n_dfa, n_states, V)).astype(np.int16)
    minb[rng.random((n_dfa, n_states, V)) < 0.4] = np.iinfo(np.int16).max
    minb[1, 4] = np.iinfo(np.int16).max           # a dead-end state
    states = rng.integers(0, n_states, B).astype(np.int32)
    dfa_ids = rng.integers(0, n_dfa, B).astype(np.int32)
    dfa_ids[0], states[0] = 1, 4
    meta_i = np.stack([rng.integers(2, 9, B),                          # budget_left
                       np.where(rng.random(B) < 0.4, rng.integers(0, V, B), -1),  # forbid
                       np.arange(B) % 2,                               # greedy rows
                       rng.integers(0, 2, B)], axis=1).astype(np.int32)  # eos_ok
    meta_f = np.stack([np.full(B, 0.7), rng.random(B)], axis=1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (
        (rng.standard_normal((B, V)) * 3).astype(np.float32), minb, dfa_ids, states,
        meta_i, meta_f)]
    before = guided_sampler.sample_rows.launches
    tok, any_tok = guided_sampler.sample_rows(*args, eos, top_p)
    torch.cuda.synchronize()
    assert guided_sampler.sample_rows.launches == before + 1
    ref_tok, ref_any = guided_sampler.sample_rows_plain(*args, eos, top_p)
    assert tok.tolist() == ref_tok.tolist()
    assert any_tok.tolist() == ref_any.tolist()
    assert not any_tok[0]


def test_wrappers_raise_on_cuda_inputs_they_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 64), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="head_dim 128"):
        attention.flash_attention(q, kv, kv, torch.ones((1, 4, 4), dtype=torch.bool, device=dev), 1.0)
    qd = torch.zeros((1, 2, 128), dtype=torch.float32, device=dev)
    kvd = torch.zeros((1, 8, 1, 128), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError, match="bf16"):
        decode_attention.decode_attention(qd, kvd, kvd, torch.ones((1, 8), dtype=torch.bool,
                                                                   device=dev), 1.0)
    qc = torch.zeros((1, 20, 32, 128), dtype=torch.bfloat16, device=dev)   # 80 rows > 64
    kvc = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="query rows"):
        decode_attention.chunk_decode_attention(
            qc, kvc, kvc, torch.ones((1, 20, 8), dtype=torch.bool, device=dev), 1.0)
    k8 = torch.zeros((1, 8, 8, 128), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 8, 8), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError, match="int8"):
        decode_attention.chunk_decode_attention_int8(
            qc[:, :1], kvc, kvc, sc, sc, torch.ones((1, 1, 8), dtype=torch.bool, device=dev),
            1.0)
    with pytest.raises(ValueError, match="scales"):
        decode_attention.decode_attention_int8(
            qc[:, 0], k8, k8, sc[..., :4], sc[..., :4],
            torch.ones((1, 8), dtype=torch.bool, device=dev), 1.0)
