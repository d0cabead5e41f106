"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built from
``bcg_tpu_torch/csrc`` at first use) and skips without them.  This module
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covered: flash prefill, bf16 decode attention (single step and chunk),
int8 decode attention (single step and chunk, at the bench-8b shapes
and at a GQA group of 5), paged decode attention over bf16, int8 and
packed-int4 block pools (single step and chunk, shuffled tables with
shared blocks and null padding) and the guided sampler.

Tolerances: bf16 attention 2e-2 absolute on outputs of magnitude ~1-4.
The kernels round the unnormalised probabilities to bf16 for the p.v
product (as the Pallas kernels do), the plain versions the normalised
ones, and each rounds its bf16 output: a few bf16 ulps (2**-8 relative).
The sampler is compared token for token, with no tolerance.
"""

import numpy as np
import pytest
import torch

from types import SimpleNamespace

from bcg_tpu_torch.models import transformer
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import init_params
from bcg_tpu_torch.models.quantize import quantize_kv_int4
from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler, paged_attention

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


def _paged_entry(rng, dev, layout, B, nblk, bs, Hkv, Dh):
    """A one-layer block pool of random K/V in ``layout`` and a table
    ``[B, nblk]`` of shuffled blocks: rows 0 and 1 share their first
    three blocks, row 2's last two columns are null padding.  Returns
    (entry, live [B, S] slots backed by a real block)."""
    N = B * nblk + 1
    spec = SimpleNamespace(num_layers=1, num_kv_heads=Hkv, head_dim=Dh)
    quant = {"bf16": False, "int8": "int8", "int4": "int4"}[layout]
    entry = paged_attention.init_block_pool(spec, N, bs, quantized=quant, device=dev)[0]
    for name in ("k", "v"):
        x = torch.from_numpy(rng.standard_normal((N - 1, bs, Hkv, Dh), np.float32)).to(dev)
        if layout == "bf16":
            entry[name][1:] = x.to(torch.bfloat16)
        else:
            qz = decode_attention.quantize_kv if layout == "int8" else quantize_kv_int4
            vals, sc = qz(x)                      # [N-1, bs, Hkv, *], [N-1, bs, Hkv]
            entry[name][1:] = vals.transpose(1, 2)
            entry[f"{name}_scale"][1:] = sc.transpose(1, 2)
    tbl = (rng.permutation(N - 1)[: B * nblk] + 1).reshape(B, nblk).astype(np.int32)
    tbl[1, :3] = tbl[0, :3]
    tbl[2, -2:] = 0
    entry["tbl"] = torch.from_numpy(tbl).to(dev)
    live = np.repeat(tbl != 0, bs, axis=1)
    return entry, live


PAGED_SHAPES = [(32, 8, 1), (32, 8, 4), (32, 8, 5), (40, 8, 1), (40, 8, 5)]
PAGED_IDS = ["bench-step", "bench-ff", "bench-spec", "g5-step", "g5-spec"]


@pytest.mark.parametrize("H,Hkv,K", PAGED_SHAPES, ids=PAGED_IDS)
@pytest.mark.parametrize("layout", ["bf16", "int8", "int4"])
def test_paged_kernel_matches_plain(dev, H, Hkv, K, layout):
    rng = np.random.default_rng([H, Hkv, K, len(layout)])
    B, nblk, bs, Dh = 6, 40, 16, 128
    entry, live = _paged_entry(rng, dev, layout, B, nblk, bs, Hkv, Dh)
    S = nblk * bs
    q = torch.from_numpy(rng.standard_normal((B, K, H, Dh), np.float32)).to(dev, torch.bfloat16)
    if K == 1:
        m = (rng.random((B, S)) < 0.6) & live
        m[3] = False                              # a fully masked row gives 0
        fn, plain = paged_attention.paged_decode_attention, \
            paged_attention.paged_decode_attention_plain
    else:
        m = (rng.random((B, K, S)) < 0.6) & live[:, None]
        m[3, 1] = False                           # a fully masked chunk row gives 0
        fn, plain = paged_attention.paged_chunk_attention, \
            paged_attention.paged_chunk_attention_plain
    mask = torch.from_numpy(m).to(dev)
    before = dict(fn.launches)
    out = fn(q, entry, mask, Dh ** -0.5)
    torch.cuda.synchronize()
    assert fn.launches[layout] == before[layout] + 1
    assert sum(fn.launches.values()) == sum(before.values()) + 1
    torch.testing.assert_close(out.float(), plain(q, entry, mask, Dh ** -0.5).float(),
                               atol=TOL, rtol=TOL)
    assert torch.all(out[3, 0 if K == 1 else 1] == 0)


@pytest.mark.parametrize("layout", ["bf16", "int8", "int4"])
def test_paged_kernel_equals_dense_kernel_on_gathered_view(dev, layout):
    """The paged kernel reads the same numbers as the dense kernel over
    the gathered dense view (int4 goes to the bf16 kernel dequantized):
    equal up to the order of the sums."""
    rng = np.random.default_rng([len(layout), 3])
    B, nblk, bs, Hkv, H, K, Dh = 4, 30, 16, 8, 32, 4, 128
    entry, live = _paged_entry(rng, dev, layout, B, nblk, bs, Hkv, Dh)
    q = torch.from_numpy(rng.standard_normal((B, K, H, Dh), np.float32)).to(dev, torch.bfloat16)
    mask = torch.from_numpy((rng.random((B, K, nblk * bs)) < 0.7) & live[:, None]).to(dev)
    out = paged_attention.paged_chunk_attention(q, entry, mask, Dh ** -0.5)
    dense = paged_attention.paged_gather_entry(entry)
    if layout == "int8":
        ref = decode_attention.chunk_decode_attention_int8(
            q, dense["k"], dense["v"], dense["k_scale"], dense["v_scale"], mask, Dh ** -0.5)
    else:
        k, v = paged_attention._dense_view(entry, torch.bfloat16)
        ref = decode_attention.chunk_decode_attention(q, k, v, mask, Dh ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)


def _int4_model_step(params, dev, K):
    """tiny-dh128 over a dense int4 cache of 70 random quantized slots
    (made on the CPU, the same bytes on every device): one decode step
    (K = 1) or one fast-forward chunk of K tokens.  Returns the logits."""
    spec = spec_for_model("bcg-tpu/tiny-dh128")
    rng = np.random.default_rng(11)
    B, S, P = 3, 96, 70
    cache = transformer.init_kv_cache(spec, B, S, torch.bfloat16, dev, quantized="int4")
    for entry in cache:
        for name in ("k", "v"):
            x = rng.standard_normal((B, P, spec.num_kv_heads, spec.head_dim), np.float32)
            vals, sc = quantize_kv_int4(torch.from_numpy(x))
            entry[name][:, :, :P] = vals.transpose(1, 2).to(dev)
            entry[f"{name}_scale"][:, :, :P] = sc.transpose(1, 2).to(dev)
    vm = torch.zeros((B, S), dtype=torch.bool)
    vm[:, :P] = torch.from_numpy(rng.random((B, P)) < 0.8)
    tok = torch.from_numpy(rng.integers(0, spec.vocab_size, (B, K))).to(dev)
    pos = vm.sum(1).to(torch.int32).to(dev)
    if K == 1:
        vm[:, P] = True
        logits, _ = transformer.decode_step(params, spec, tok[:, 0], P, pos, cache, vm.to(dev))
    else:
        cvalid = torch.ones((B, K), dtype=torch.bool)
        cvalid[1, K - 1:] = False
        cvalid[2, 1:] = False
        logits, _ = transformer.decode_chunk(params, spec, tok, cvalid.to(dev),
                                             torch.tensor(P, device=dev),
                                             pos[:, None] + torch.arange(K, device=dev), cache,
                                             vm.to(dev))
    return logits.float().cpu()


@pytest.mark.parametrize("K", [1, 4], ids=["step", "chunk"])
def test_dense_int4_cache_decodes_through_the_bf16_kernels(dev, K):
    """The model's decode step and chunk over a dense int4 cache attend
    through B3a / B3a-chunk on the dequantized view (no plain version on
    the card) and agree with the same bf16 weights on the CPU.  Limit
    0.15 on logits of magnitude ~3.5, as chip_smoke's small reference: a
    fresh key computed one bf16 ulp apart can land a whole int4 step away
    (the CPU's bf16 and f32 runs of this input differ by 0.07-0.08)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(3)
    p16 = {k: v.to(torch.bfloat16)
           for k, v in init_params(spec_for_model("bcg-tpu/tiny-dh128"), gen, "cpu",
                                   torch.float32).items()}
    fn = decode_attention.decode_attention if K == 1 else decode_attention.chunk_decode_attention
    before = fn.launches
    got = _int4_model_step({k: v.to(dev) for k, v in p16.items()}, dev, K)
    assert fn.launches == before + 2                  # one per layer
    ref = _int4_model_step(p16, "cpu", K)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 0.15


def test_paged_wrappers_raise_on_cuda_inputs_they_do_not_take(dev):
    rng = np.random.default_rng(0)
    entry, _ = _paged_entry(rng, dev, "int4", 3, 4, 16, 8, 128)
    q = torch.zeros((3, 1, 32, 128), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="mask"):
        paged_attention.paged_decode_attention(
            q, entry, torch.ones((3, 63), dtype=torch.bool, device=dev), 1.0)
    bad = dict(entry, tbl=entry["tbl"].long())
    with pytest.raises(ValueError, match="int32"):
        paged_attention.paged_decode_attention(
            q, bad, torch.ones((3, 64), dtype=torch.bool, device=dev), 1.0)
    with pytest.raises(TypeError, match="bf16"):
        paged_attention.paged_decode_attention(
            q.float(), entry, torch.ones((3, 64), dtype=torch.bool, device=dev), 1.0)


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


# ------------------------------------------------------------ weights (B5)

# (in, out) of the int4 weights the engine serves: tiny-test (groups of 32
# and 64, F = 32), tiny-dh128 and bench-8b (groups of 128; F = 1024 splits
# the contraction across blocks).
W4_SHAPES = [(64, 64), (64, 32), (128, 64), (256, 256), (512, 256),
             (4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)]
W4_IDS = ["tiny-wq-g32", "tiny-wk-F32", "tiny-wdown-g64", "dh128-wq", "dh128-wdown",
          "8b-wq", "8b-wk", "8b-wgate", "8b-wdown"]
# Relative L2 error per output row, kernel vs plain version.  Both take
# the same bf16 products (x and the bf16-rounded dequantized weight) and
# sum them in f32 in another order: ~1e-6 at these depths.  A wrong nibble,
# group scale or half reads O(1).
W4_REL_ROW_TOL = 1e-3


def _rel_rows(out, ref):
    return ((out - ref).pow(2).sum(-1).sqrt() / ref.pow(2).sum(-1).sqrt().clamp_min(1e-30)).max().item()


@pytest.mark.parametrize("M", [1, 10, 50, 256])
@pytest.mark.parametrize("shape", W4_SHAPES, ids=W4_IDS)
def test_w4a16_kernel_matches_plain(dev, shape, M):
    from bcg_tpu_torch.models.quantize import quantize_weight_int4
    from bcg_tpu_torch.ops import w4_matmul

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(shape[0] + shape[1] + M)
    w = torch.randn(shape, generator=gen, device=dev) / shape[0] ** 0.5
    q = quantize_weight_int4(w.to(torch.bfloat16))
    x = torch.randn((M, shape[0]), generator=gen, device=dev).to(torch.bfloat16)
    before = w4_matmul.w4a16_matmul.launches
    out = w4_matmul.w4a16_matmul(x, q["q4"], q["gscale"])
    torch.cuda.synchronize()
    assert w4_matmul.w4a16_matmul.launches == before + 1
    ref = w4_matmul.w4a16_matmul_plain(x, q["q4"], q["gscale"])
    assert out.dtype == torch.float32 and out.shape == (M, shape[1])
    assert torch.isfinite(out).all()
    assert _rel_rows(out, ref) <= W4_REL_ROW_TOL


def test_w4a16_kernel_at_the_bench_lm_head_and_3d_rows(dev):
    from bcg_tpu_torch.models.quantize import quantize_weight_int4
    from bcg_tpu_torch.ops import w4_matmul

    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    q = quantize_weight_int4((torch.randn((4096, 151936), generator=gen, device=dev)
                              / 64.0).to(torch.bfloat16))
    x = torch.randn((2, 5, 4096), generator=gen, device=dev).to(torch.bfloat16)
    out = w4_matmul.w4a16_matmul(x, q["q4"], q["gscale"])
    ref = w4_matmul.w4a16_matmul_plain(x.reshape(10, 4096), q["q4"], q["gscale"])
    assert out.shape == (2, 5, 151936)
    assert _rel_rows(out.reshape(10, -1), ref) <= W4_REL_ROW_TOL


def test_w4a16_wrapper_raises_on_shapes_it_does_not_take(dev):
    from bcg_tpu_torch.models.quantize import quantize_weight_int4
    from bcg_tpu_torch.ops import w4_matmul

    q = quantize_weight_int4(torch.randn((64, 40), device=dev))           # F % 16
    with pytest.raises(ValueError, match="multiple of 16"):
        w4_matmul.w4a16_matmul(torch.zeros((4, 64), dtype=torch.bfloat16, device=dev),
                               q["q4"], q["gscale"])
    q = quantize_weight_int4(torch.randn((64, 32), device=dev))
    with pytest.raises(ValueError, match="rows"):
        w4_matmul.w4a16_matmul(torch.zeros((257, 64), dtype=torch.bfloat16, device=dev),
                               q["q4"], q["gscale"])


@pytest.mark.parametrize("M", [1, 10, 17, 50, 300])
def test_int8_dense_on_cuda_equals_the_cpu(dev, M):
    """W8A8 on the card (``torch._int_mm``, rows padded to 17 where it
    needs more than 16) gives the CPU's bits: an exact int32 product and
    the same f32 elementwise steps."""
    from bcg_tpu_torch.models.quantize import dense, quantize_weight

    gen = torch.Generator(device="cpu")
    gen.manual_seed(M)
    w = (torch.randn((4096, 1024), generator=gen) / 64.0).to(torch.bfloat16)
    x = torch.randn((M, 4096), generator=gen).to(torch.bfloat16)
    q = quantize_weight(w)
    ref = dense(x, q, torch.float32)
    got = dense(x.to(dev), {k: v.to(dev) for k, v in q.items()}, torch.float32)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_quantized_model_on_cuda_runs_the_kernels(dev, mode):
    """tiny-dh128 with quantized weights: prefill and decode steps on the
    card against the same bf16 weights on the CPU; int4's decode-shaped
    matmuls launch B5 (7 per layer and the LM head, each step)."""
    from bcg_tpu_torch.models.quantize import quantize_params
    from bcg_tpu_torch.ops import w4_matmul

    spec = spec_for_model("bcg-tpu/tiny-dh128")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    p16 = {k: v.to(torch.bfloat16) for k, v in init_params(spec, gen, "cpu", torch.float32).items()}
    qp = quantize_params(p16, spec, mode=mode)

    def run(params, d):
        rng = np.random.default_rng(1)
        B, L, S = 3, 40, 48
        tokens = torch.from_numpy(rng.integers(0, 256, (B, L))).to(d)
        valid = torch.ones((B, L), dtype=torch.bool, device=d)
        valid[1, :9] = False
        cache = transformer.init_kv_cache(spec, B, S, torch.bfloat16, d)
        logits, cache = transformer.prefill(params, spec, tokens, valid, cache)
        outs = [logits.float().cpu()]
        vm = torch.zeros((B, S), dtype=torch.bool, device=d)
        vm[:, :L] = valid
        for i in range(3):
            vm[:, L + i] = True
            tok = torch.from_numpy(rng.integers(0, 256, (B,))).to(d)
            logits, cache = transformer.decode_step(params, spec, tok, L + i,
                                                    valid.sum(1).to(torch.int32) + i, cache, vm)
            outs.append(logits.float().cpu())
        return torch.stack(outs)

    before = w4_matmul.w4a16_matmul.launches
    got = run({k: ({p: t.to(dev) for p, t in v.items()} if isinstance(v, dict) else v.to(dev))
               for k, v in qp.items()}, dev)
    launched = w4_matmul.w4a16_matmul.launches - before
    assert launched == (4 * (7 * spec.num_layers + 1) if mode == "int4" else 0)
    ref = run(qp, "cpu")
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 0.15


def test_int4_engine_kill_switch_raises_on_cuda(dev, monkeypatch):
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    monkeypatch.setenv("BCG_TPU_DISABLE_W4_KERNEL", "1")
    with pytest.raises(ValueError, match="BCG_TPU_DISABLE_W4_KERNEL"):
        TorchEngine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-dh128",
                                 max_model_len=512, quantization="int4"), device=dev)
