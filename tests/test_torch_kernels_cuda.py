"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built from
``bcg_tpu_torch/csrc`` at first use) and skips without them.  This module
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch; there, skip the JAX test configuration:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py

Covered: flash prefill (groups 1-7, edge shapes), bf16 decode attention
(single step — split over S, at a merged batch of 40 rows on one split,
repeatable bit for bit and replayed in a CUDA graph — and chunk),
int8 decode attention (single step and chunk, at the bench-8b shapes
and at a GQA group of 5), paged decode attention over bf16, int8 and
packed-int4 block pools (single step and chunk, shuffled tables with
shared blocks and null padding), the eight split forms of the int8 and
paged kernels (each against its plain version and the plain version of
its split arithmetic at the plan, at many splits with a ragged last one,
with live slots only in the first 64 positions and at one split;
repeatable bit for bit and replayed in a CUDA graph) and the guided
sampler (one cluster a row: at 1 to 150 rows, both vocabularies and top_p
values, with the edge rows of ``_sampler_case``; repeatable bit for bit and
replayed in a CUDA graph; a row no cluster plan holds raises).

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
@pytest.mark.parametrize("H,Hkv", [(4, 4), (8, 4), (32, 8), (10, 2), (14, 2)],
                         ids=["g1", "g2", "g4", "g5", "g7"])
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
@pytest.mark.parametrize("H,Hkv", [(4, 4), (32, 8), (16, 2), (10, 2), (14, 2)],
                         ids=["g1", "g4", "g8", "g5", "g7"])
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


def _flash_case(dev, rng, B, T, S, H, Hkv, m):
    Dh = 128
    q = torch.from_numpy(rng.standard_normal((B, T, H, Dh), np.float32)).to(dev, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal((B, S, 2, Hkv, Dh), np.float32))
    cache = cache.to(dev, torch.bfloat16)
    k, v = cache[:, :, 0], cache[:, :, 1]
    mask = torch.from_numpy(m).to(dev)
    out = attention.flash_attention(q, k, v, mask, Dh ** -0.5)
    torch.cuda.synchronize()
    ref = attention.flash_attention_plain(q, k, v, mask, Dh ** -0.5)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    assert torch.all(out[~mask.any(dim=2)] == 0)


@pytest.mark.parametrize("case", ["T1", "T65", "S-under-a-tile", "last-tile-only",
                                  "bench-group-T512"])
def test_flash_kernel_edge_shapes(dev, case):
    """One query row; one row past a block's positions; fewer keys than a
    64-key tile; a mask live only in the last (ragged) key tile; the
    bench-8b group of 4 at a mid-size prefill."""
    rng = np.random.default_rng(len(case))
    B, T, S, H, Hkv = {"T1": (2, 1, 300, 32, 8), "T65": (2, 65, 300, 32, 8),
                       "S-under-a-tile": (2, 37, 40, 32, 8),
                       "last-tile-only": (2, 70, 330, 32, 8),
                       "bench-group-T512": (3, 512, 1500, 32, 8)}[case]
    if case == "last-tile-only":
        m = np.zeros((B, T, S), bool)
        m[:, :, 320:] = rng.random((B, T, S - 320)) < 0.6
        m[0, 5] = False                                  # a dead row
    elif case == "bench-group-T512":
        m = _prefix_mask(rng, B, T, S, dead_rows=True)
    else:
        m = rng.random((B, T, S)) < 0.5
    _flash_case(dev, rng, B, T, S, H, Hkv, m)


def _decode_inputs(dev, rng, B, S, H, Hkv):
    Dh = 128
    q = torch.from_numpy(rng.standard_normal((B, H, Dh), np.float32)).to(dev, torch.bfloat16)
    cache = torch.from_numpy(rng.standard_normal((2, B, S + 3, Hkv, Dh), np.float32))
    cache = cache.to(dev, torch.bfloat16)
    return q, cache[0, :, :S], cache[1, :, :S]


@pytest.mark.parametrize("case", ["B1-S8191", "live-first-64", "one-split"])
def test_decode_kernel_split_shapes(dev, case):
    """Many splits with a ragged last one (B = 1, S = 8191); live slots
    only in the first 64 (every other split empty); B * Hkv >= 264 (one
    split).  Held to the plain version and to the split arithmetic's
    plain version at the plan the wrapper uses."""
    rng = np.random.default_rng(len(case) + 1)
    B, S, H, Hkv = {"B1-S8191": (1, 8191, 32, 8), "live-first-64": (3, 5000, 32, 8),
                    "one-split": (33, 700, 32, 8)}[case]
    q, k, v = _decode_inputs(dev, rng, B, S, H, Hkv)
    m = rng.random((B, S)) < 0.7
    if case == "live-first-64":
        m[:, 64:] = False
    mask = torch.from_numpy(m).to(dev)
    n_split, split_len = decode_attention._split_for(q, Hkv, S, 1)
    assert (n_split == 1) == (case == "one-split")
    scale = 128 ** -0.5
    out = decode_attention.decode_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    ref = decode_attention.decode_attention_plain(q, k, v, mask, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    split_ref = decode_attention.decode_attention_split_plain(q, k, v, mask, scale, n_split,
                                                              split_len)
    torch.testing.assert_close(out.float(), split_ref.float(), atol=TOL, rtol=TOL)


def test_decode_kernel_at_a_merged_batch_of_forty(dev):
    """The serving scheduler's merged batch of four 10-agent games: B = 40
    rows at bench-8b's heads over a ~5k window, each row left-padded by
    its own prompt length.  B * Hkv = 320 blocks fill two an SM of 132:
    the one-split plan, held to the plain version and to the split
    arithmetic's plain version at that plan."""
    rng = np.random.default_rng(40)
    B, S, H, Hkv = 40, 5072, 32, 8
    q, k, v = _decode_inputs(dev, rng, B, S, H, Hkv)
    m = np.zeros((B, S), bool)
    for b in range(B):
        m[b, rng.integers(0, S // 3):] = True
    mask = torch.from_numpy(m).to(dev)
    n_split, split_len = decode_attention._split_for(q, Hkv, S, 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (n_split == 1) == (B * Hkv >= 2 * sms)
    scale = 128 ** -0.5
    launches = decode_attention.decode_attention.launches
    out = decode_attention.decode_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert decode_attention.decode_attention.launches == launches + 1
    ref = decode_attention.decode_attention_plain(q, k, v, mask, scale)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL, rtol=TOL)
    split_ref = decode_attention.decode_attention_split_plain(q, k, v, mask, scale, n_split,
                                                              split_len)
    torch.testing.assert_close(out.float(), split_ref.float(), atol=TOL, rtol=TOL)


def test_decode_kernel_is_deterministic_and_replays_in_a_graph(dev):
    """Two calls are bit-identical (the last block merges the splits in
    split order, whatever order the blocks finish in); the call captured
    in a CUDA graph and replayed twice gives the same bits; a shrinking
    then growing shape leaves the arrival counters at 0."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv = 4, 3000, 32, 8
    q, k, v = _decode_inputs(dev, rng, B, S, H, Hkv)
    mask = torch.from_numpy(rng.random((B, S)) < 0.8).to(dev)
    scale = 128 ** -0.5
    assert decode_attention._split_for(q, Hkv, S, 1)[0] > 1
    first = decode_attention.decode_attention(q, k, v, mask, scale)
    second = decode_attention.decode_attention(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention.decode_attention(q, k, v, mask, scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention.decode_attention(q, k, v, mask, scale)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)

    # Shrink (fewer pairs, shorter window), then grow past the first shape.
    for b, s in [(1, 700), (2, 1500), (6, 4000)]:
        qs, ks, vs = _decode_inputs(dev, rng, b, s, H, Hkv)
        ms = torch.from_numpy(rng.random((b, s)) < 0.8).to(dev)
        got = decode_attention.decode_attention(qs, ks, vs, ms, scale)
        ref = decode_attention.decode_attention_plain(qs, ks, vs, ms, scale)
        torch.testing.assert_close(got.float(), ref.float(), atol=TOL, rtol=TOL)
    torch.cuda.synchronize()
    counts = decode_attention._workspaces[q.device].count
    assert int(counts.abs().sum()) == 0


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


# The split forms of the bf16 chunk kernel (B3a-chunk: R = 16, one
# m-tile, and R = 20, two m-tiles and the bf16 ring), the int8 kernel
# (B3b) and the paged kernel (B4): (cache, K), K = 0 for the single step;
# the chunks at their home paths' K (fast-forward 4, speculative verify 5).
SPLIT_FORMS = [("dense-bf16", 4), ("dense-bf16", 5), ("dense-int8", 0), ("dense-int8", 4),
               ("bf16", 0), ("bf16", 5), ("int8", 0), ("int8", 5), ("int4", 0), ("int4", 4)]
SPLIT_FORM_IDS = ["b3a-chunk-r16", "b3a-chunk-r20", "b3b-step", "b3b-chunk", "b4-bf16-step",
                  "b4-bf16-chunk", "b4-int8-step", "b4-int8-chunk", "b4-int4-step",
                  "b4-int4-chunk"]


def _split_inputs(dev, rng, form, K, B, S):
    """q [B, max(K, 1), 32, 128] and the cache of one split form over an
    S-position window (a paged pool in whole blocks of 16, S rounded up:
    :func:`_paged_entry`), with the [B, S] slots a mask may make live."""
    H, Hkv, Dh = 32, 8, 128
    q = torch.from_numpy(rng.standard_normal((B, max(K, 1), H, Dh), np.float32))
    q = q.to(dev, torch.bfloat16)
    if form.startswith("dense"):
        return q, _cache_views(rng, dev, B, S, Hkv, Dh, int8=form == "dense-int8"), \
            np.ones((B, S), bool)
    entry, live = _paged_entry(rng, dev, form, B, -(-S // 16), 16, Hkv, Dh)
    return q, entry, live


def _split_calls(form, K, q, cache, m):
    """The wrapper's call, its plain version, the plain version of the
    split arithmetic at a given plan, the kernel's plan and the wrapper
    (its ``.launches``) for one split form; m [B, max(K, 1), S] numpy."""
    scale = 128 ** -0.5
    mask = torch.from_numpy(m[:, 0] if K == 0 else m).to(q.device)
    if form == "dense-bf16":
        k, v = cache[:2]
        da = decode_attention
        args = (q, k, v, mask, scale)

        def split(n, length):
            return da.decode_attention_split_plain(q, k, v, mask, scale, n, length)

        return (lambda: da.chunk_decode_attention(*args)), \
            (lambda: da.chunk_decode_attention_plain(*args)), split, \
            da.chunk_split_plan(q, k, mask), da.chunk_decode_attention
    if form == "dense-int8":
        k, v, ks, vs = cache
        qq = q[:, 0] if K == 0 else q
        da = decode_attention
        fn, plain = ((da.decode_attention_int8, da.decode_attention_int8_plain) if K == 0 else
                     (da.chunk_decode_attention_int8, da.chunk_decode_attention_int8_plain))
        args = (qq, k, v, ks, vs, mask, scale)

        def split(n, length):
            return da.decode_attention_split_plain(qq, k, v, mask, scale, n, length,
                                                   k_scale=ks, v_scale=vs)

        return (lambda: fn(*args)), (lambda: plain(*args)), split, \
            da.int8_split_plan(qq, k, mask), fn
    pa = paged_attention
    fn, plain = ((pa.paged_decode_attention, pa.paged_decode_attention_plain) if K == 0 else
                 (pa.paged_chunk_attention, pa.paged_chunk_attention_plain))

    def split(n, length):
        return pa.paged_attention_split_plain(q, cache, mask, scale, n, length)

    plan = pa.split_plan(q, cache, mask[:, None] if K == 0 else mask)
    return (lambda: fn(q, cache, mask, scale)), (lambda: plain(q, cache, mask, scale)), split, \
        plan, fn


def _launches(fn, form):
    return fn.launches if form.startswith("dense") else fn.launches[form]


@pytest.mark.parametrize("case", ["bench", "ragged-many", "live-first-64", "one-split"])
@pytest.mark.parametrize("form,K", SPLIT_FORMS, ids=SPLIT_FORM_IDS)
def test_split_forms_match_plain_and_split_plain(dev, form, K, case):
    """A bench-8b-sized call (several splits); many splits with a ragged
    last one; live slots only in the first 64 positions (every other
    split empty); B * Hkv >= 264 (one split).  Held to the plain version
    and to the split arithmetic's plain version at the plan the wrapper
    uses; a fully masked query row gives 0."""
    rng = np.random.default_rng([len(form), K, len(case)])
    B, S = {"bench": (10, 3000), "ragged-many": (3, 8150), "live-first-64": (3, 5000),
            "one-split": (33, 700)}[case]
    q, cache, live = _split_inputs(dev, rng, form, K, B, S)
    S = live.shape[1]
    m = (rng.random((B, q.shape[1], S)) < 0.7) & live[:, None]
    if case == "live-first-64":
        m[:, :, 64:] = False
    m[1, -1] = False                               # a fully masked query row gives 0
    call, plain, split, (n_split, split_len), fn = _split_calls(form, K, q, cache, m)
    assert (n_split == 1) == (case == "one-split")
    if case == "ragged-many":
        assert n_split >= 8 and S - (n_split - 1) * split_len != split_len
    before = _launches(fn, form)
    out = call()
    torch.cuda.synchronize()
    assert _launches(fn, form) == before + 1
    torch.testing.assert_close(out.float(), plain().float(), atol=TOL, rtol=TOL)
    torch.testing.assert_close(out.float(), split(n_split, split_len).float(), atol=TOL,
                               rtol=TOL)
    out4 = out[:, None] if out.dim() == 3 else out
    assert torch.all(out4[1, -1] == 0)


@pytest.mark.parametrize("form,K", SPLIT_FORMS, ids=SPLIT_FORM_IDS)
def test_split_forms_are_deterministic_and_replay_in_a_graph(dev, form, K):
    """Two calls are bit-identical (the last block merges the splits in
    split order); after one call at the shape, the call captured in a
    CUDA graph and replayed twice gives the same bits; the shared
    workspace's arrival counters are 0 after it all."""
    rng = np.random.default_rng([len(form), K, 9])
    B, S = 4, 3000
    q, cache, live = _split_inputs(dev, rng, form, K, B, S)
    m = (rng.random((B, q.shape[1], live.shape[1])) < 0.8) & live[:, None]
    call, _, _, (n_split, _), _ = _split_calls(form, K, q, cache, m)
    assert n_split > 1
    first = call()
    second = call()
    torch.cuda.synchronize()
    assert torch.equal(first, second)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)
    counts = decode_attention._workspaces[q.device].count
    assert int(counts.abs().sum()) == 0


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


def _sampler_case(B, V, seed):
    """Sampler arguments: random rows over a small DFA, and where B > 6 the
    edge rows: 0 a dead-end state; 1 tied maxima (greedy, the first index
    wins); 2 forbid on the greedy argmax; 3 a one-token nucleus that is
    also forbidden (greedy: the 2^24 sentinel at top_p < 1); 4 all gated,
    EOS too (sampled: Vp - 1); 5 u = 0; 6 u = 0.99999994 over three equal
    weights.  Row 6's weights make every sum exact: on a dense row a
    target one ulp below the total sits within rounding of a CDF step,
    where kernel and plain version, summing in other orders, may part."""
    rng = np.random.default_rng([B, V, seed])
    n_dfa, n_states, eos = 2, 12, 3
    big = np.iinfo(np.int16).max
    minb = rng.integers(1, 6, (n_dfa, n_states, V)).astype(np.int16)
    minb[rng.random((n_dfa, n_states, V)) < 0.4] = big
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    states = rng.integers(0, 5, B).astype(np.int32)
    dfa_ids = rng.integers(0, n_dfa, B).astype(np.int32)
    meta_i = np.stack([rng.integers(2, 9, B),                          # budget_left
                       np.where(rng.random(B) < 0.4, rng.integers(0, V, B), -1),  # forbid
                       np.arange(B) % 2,                               # greedy rows
                       rng.integers(0, 2, B)], axis=1).astype(np.int32)  # eos_ok
    meta_f = np.stack([np.full(B, 0.7), rng.random(B)], axis=1).astype(np.float32)
    if B > 6:
        for r in range(7):
            dfa_ids[r], states[r] = 1, 5 + r
        minb[1, 5] = big
        minb[1, 6] = 1
        tied = [V // 3, V // 3 + 5, V - 2]
        logits[1, tied] = logits[1].max() + 1.0
        meta_i[1, 1:3] = (-1, 1)
        meta_i[2, 2:4] = (1, 0)
        gate = (minb[1, 7] <= meta_i[2, 0]) & (np.arange(V) != eos)
        meta_i[2, 1] = int(np.argmax(np.where(gate, logits[2], -np.inf)))
        one = V // 2
        minb[1, 8, one] = 1
        logits[3, one] = logits[3].max() + 60.0
        meta_i[3, 1:3] = (one, 1)
        minb[1, 9] = big
        meta_i[4, 2:4] = (0, 0)
        meta_i[5, 2], meta_f[5, 1] = 0, 0.0
        three = [5, V // 2, V - 1]
        minb[1, 11] = big
        minb[1, 11, three] = 1
        logits[6, three] = 1.5
        dfa_ids[6], states[6] = 1, 11
        meta_i[6, 1:4] = (-1, 0, 0)
        meta_f[6, 1] = np.float32(0.99999994)
    return (logits, minb, dfa_ids, states, meta_i, meta_f), eos


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("V", [151936, 300], ids=["qwen-vocab", "offlane-v300"])
@pytest.mark.parametrize("B", [1, 10, 33, 150])
def test_sampler_kernel_matches_plain(dev, B, V, top_p):
    case, eos = _sampler_case(B, V, int(top_p * 10))
    args = [torch.from_numpy(a).to(dev) for a in case]
    before = guided_sampler.sample_rows.launches
    tok, any_tok = guided_sampler.sample_rows(*args, eos, top_p)
    torch.cuda.synchronize()
    assert guided_sampler.sample_rows.launches == before + 1
    ref_tok, ref_any = guided_sampler.sample_rows_plain(*args, eos, top_p)
    assert tok.tolist() == ref_tok.tolist()
    assert any_tok.tolist() == ref_any.tolist()
    if B > 6:
        Vp, _ = guided_sampler.vocab_rows(V)
        assert not any_tok[0]
        assert tok[1] == V // 3
        assert tok[2] != args[4][2, 1]
        if top_p < 1.0:
            assert tok[3] == 1 << 24
        assert tok[4] == Vp - 1
        assert tok[6] == V - 1


def test_sampler_kernel_is_deterministic_and_replays_in_a_graph(dev):
    case, eos = _sampler_case(10, 151936, 3)
    args = [torch.from_numpy(a).to(dev) for a in case]
    for top_p in (1.0, 0.9):
        first = guided_sampler.sample_rows_cuda(*args, eos, top_p)
        again = guided_sampler.sample_rows_cuda(*args, eos, top_p)
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            guided_sampler.sample_rows_cuda(*args, eos, top_p)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tok, any_tok = guided_sampler.sample_rows_cuda(*args, eos, top_p)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(tok, first[0]) and torch.equal(any_tok, first[1])
        # The graph reads its inputs in place: new uniforms, replay == eager.
        args[5][:, 1] = torch.rand(10, device=dev)
        graph.replay()
        eager = guided_sampler.sample_rows_cuda(*args, eos, top_p)
        torch.cuda.synchronize()
        assert torch.equal(tok, eager[0]) and torch.equal(any_tok, eager[1])


def test_sampler_kernel_without_a_plan_raises(dev):
    V = 1 << 21                     # no cluster of 16 holds the row's x
    args = (torch.zeros((1, V), device=dev), torch.ones((1, 1, V), dtype=torch.int16, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev),
            torch.tensor([[4, -1, 1, 1]], dtype=torch.int32, device=dev),
            torch.tensor([[1.0, 0.5]], device=dev))
    before = guided_sampler.sample_rows.launches
    with pytest.raises(ValueError, match="no cluster plan"):
        guided_sampler.sample_rows(*args, 3, 1.0)
    assert guided_sampler.sample_rows.launches == before


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
# and 64, F = 32), tiny-dh128 and bench-8b (groups of 128; w_down's
# contraction is split across blocks); and two ragged ones: 96 packed
# rows in groups of 32 (a half chunk of 64 at the end), and an output
# width that ends a column tile early.
W4_SHAPES = [(64, 64), (64, 32), (128, 64), (256, 256), (512, 256),
             (4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096), (192, 48),
             (4096, 1040)]
W4_IDS = ["tiny-wq-g32", "tiny-wk-F32", "tiny-wdown-g64", "dh128-wq", "dh128-wdown",
          "8b-wq", "8b-wk", "8b-wgate", "8b-wdown", "ragged-P96-g32", "ragged-F1040"]
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


def _w4_case(dev, D, F, M, seed):
    from bcg_tpu_torch.models.quantize import quantize_weight_int4

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q = quantize_weight_int4((torch.randn((D, F), generator=gen, device=dev)
                              / D ** 0.5).to(torch.bfloat16))
    x = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
    return x, q["q4"], q["gscale"]


# Plans the planner may not pick for these shapes: one k-group a column
# (wc 16), sixteen (wc 1), contraction splits with a ragged last one, and
# fewer blocks than tiles (each block walking several), at M = 10 and at
# M = 70 (two row blocks of 64).
W4_PLANS = [(16, 512, 3), (1, 128, 64), (4, 256, 5), (8, 128, 1), (2, 64, 7)]


@pytest.mark.parametrize("M", [10, 70])
@pytest.mark.parametrize("wc,kb,gx", W4_PLANS, ids=["wc16-2split-walk", "wc1-5split",
                                                     "wc4-3split-walk", "wc8-one-block",
                                                     "wc2-9split-walk"])
def test_w4a16_kernel_matches_plain_at_any_plan(dev, wc, kb, gx, M):
    from bcg_tpu_torch.ops import w4_matmul

    D, F = 1152, 1024                                   # P = 576: 9 chunks of 64
    x, q4, gs = _w4_case(dev, D, F, M, wc + kb + M)
    nt = 2 if M <= 16 else 8
    mblocks = -(-M // (8 * nt))
    splits = -(-(D // 2) // kb)
    plan = w4_matmul.W4Plan(nt, wc, splits, kb, gx, mblocks)
    out = w4_matmul.w4a16_matmul_cuda(x, q4, gs, plan)
    torch.cuda.synchronize()
    assert _rel_rows(out, w4_matmul.w4a16_matmul_plain(x, q4, gs)) <= W4_REL_ROW_TOL
    ws = w4_matmul._workspaces.get(x.device)
    assert ws is None or int(ws.count.abs().sum()) == 0


def test_w4a16_kernel_is_deterministic_and_replays_in_a_graph(dev):
    """Two calls are bit-identical (the last block of a tile adds the
    splits in split order), one call is one launch, a captured call
    replays to the same bits, and the workspace refuses to grow inside a
    capture; the arrival counters are 0 after it all."""
    from bcg_tpu_torch.ops import w4_matmul

    x, q4, gs = _w4_case(dev, 12288, 4096, 10, 21)      # bench-8b w_down: split
    plan = w4_matmul._plan_for(10, 6144, 4096, x.device.index)
    assert plan.splits > 1
    before = w4_matmul.w4a16_matmul.launches
    first = w4_matmul.w4a16_matmul(x, q4, gs)
    second = w4_matmul.w4a16_matmul(x, q4, gs)
    torch.cuda.synchronize()
    assert w4_matmul.w4a16_matmul.launches == before + 2
    assert torch.equal(first, second)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w4_matmul.w4a16_matmul(x, q4, gs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = w4_matmul.w4a16_matmul(x, q4, gs)
    for _ in range(2):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)

    # A call needing a larger workspace than any before it (256 rows in 96
    # splits: 96 * 256 * 4096 partials), inside a capture.
    x256 = x[torch.arange(256, device=dev) % 10].contiguous()
    big = w4_matmul.W4Plan(8, 16, 96, 64, 1, 4)
    ws = w4_matmul._workspaces[x.device]
    assert ws.part.numel() < 96 * 256 * 4096
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph):
            w4_matmul.w4a16_matmul_cuda(x256, q4, gs, big)
    torch.cuda.synchronize()
    assert int(ws.count.abs().sum()) == 0


def test_w4a16_kernel_takes_only_its_layout(dev):
    from bcg_tpu_torch.ops import w4_matmul

    x, q4, gs = _w4_case(dev, 256, 64, 4, 2)
    with pytest.raises(ValueError, match="output-major"):
        w4_matmul.w4a16_matmul(x, q4.contiguous(), gs)


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


def test_safetensors_file_loads_onto_cuda_bit_exact(dev, tmp_path):
    """A file written by the port's safetensors writer (from tensors on
    the card) loads back onto the card bit for bit, in every dtype the
    loader reads, and a checkpoint of tiny-dh128 written in the HF layout
    loads to the same leaves."""
    from bcg_tpu_torch.models import loader, safetensors_np

    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    tensors = {
        "bf16": torch.randn((33, 17), generator=gen, device=dev).to(torch.bfloat16),
        "f16": torch.randn((5,), generator=gen, device=dev).to(torch.float16),
        "f32": torch.randn((4, 3), generator=gen, device=dev),
        "i8": torch.randint(-128, 128, (9,), generator=gen, device=dev, dtype=torch.int8),
        "u8": torch.randint(0, 256, (9,), generator=gen, device=dev, dtype=torch.uint8),
        "i32": torch.randint(-9, 9, (2, 2), generator=gen, device=dev, dtype=torch.int32),
        "i64": torch.randint(-9, 9, (3,), generator=gen, device=dev, dtype=torch.int64),
    }
    path = str(tmp_path / "t.safetensors")
    safetensors_np.save_file(tensors, path)
    back = safetensors_np.load_file(path, dev)
    for name, t in tensors.items():
        assert back[name].device == t.device and back[name].dtype == t.dtype
        assert torch.equal(back[name], t), name

    spec = spec_for_model("bcg-tpu/tiny-dh128")
    params = init_params(spec, gen, dev)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    safetensors_np.save_file(
        [(loader.hf_name(n), t.t() if n.split(".")[-1] in loader._TRANSPOSED else t)
         for n, t in params.items()], str(ckpt / "model.safetensors"))
    loaded = loader.load_checkpoint_params(spec, "bcg-tpu/tiny-dh128", dev, ckpt_dir=str(ckpt))
    assert list(loaded) == list(params)
    for name, t in params.items():
        assert loaded[name].device == t.device and loaded[name].is_contiguous()
        assert torch.equal(loaded[name], t), name


def test_launch_census_counts_one_decode_step_on_the_card(dev, monkeypatch):
    """The census of a decode step on the card: the profiled kernels
    between its two marks agree with the wrappers' launches (one B3a a
    layer, one B2), and two calls of the same shape count the same."""
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.obs import hlo

    schema = {"type": "object",
              "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
              "required": ["decision"], "additionalProperties": False}
    monkeypatch.setenv("BCG_TPU_HLO_CENSUS", "1")
    eng = TorchEngine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-dh128",
                                   max_model_len=1024), device=dev)
    records = []
    try:
        for _ in range(2):
            hlo.reset()
            eng.batch_generate_json([("sys", "vote now " * 20, schema)] * 10,
                                    temperature=0.0, max_tokens=24)
            records.append(hlo.snapshot()["decode_loop"])
    finally:
        monkeypatch.undo()
        hlo.reset()
    layers = spec_for_model("bcg-tpu/tiny-dh128").num_layers
    census = records[0]
    assert "error" not in census and census["backend"] == "cuda"
    assert census["kernels"]["decode_attention"] == census["launches"]["decode_attention"] == layers
    assert census["kernels"]["guided_sampler"] == census["launches"]["guided_sampler"] == 1
    assert census["kernels"]["matmul"] >= 7 * layers
    assert records[1] == census


def test_host_sync_audit_keeps_seams_per_thread(dev, monkeypatch):
    """On the card the audit counts a synchronizing read outside a seam
    once, at its source line; the same read inside a seam goes uncounted
    there, but another thread's read while the seam is open is counted;
    and ``reset`` puts back the sync debug mode it found."""
    import threading

    from bcg_tpu_torch.obs import counters, hostsync

    x = torch.ones(4, device=dev)
    torch.cuda.set_sync_debug_mode("default")
    monkeypatch.setenv("BCG_TPU_HOSTSYNC", "1")
    hostsync.reset()
    try:
        audit = hostsync.auditor()
        assert audit.intercepting() and torch.cuda.get_sync_debug_mode() == 1

        def unexpected():
            return counters.value("engine.hostsync.site.device_sync")

        before = unexpected()
        x.sum().item()
        assert unexpected() == before + 1
        opened, done = threading.Event(), threading.Event()

        def seam():
            with hostsync.expected():
                x.sum().item()
                opened.set()
                done.wait(30)

        t = threading.Thread(target=seam)
        t.start()
        assert opened.wait(30)
        assert unexpected() == before + 1   # the seam's own read
        x.sum().item()                      # another thread, the seam still open
        done.set()
        t.join()
        assert unexpected() == before + 2
    finally:
        monkeypatch.undo()
        hostsync.reset()
    assert torch.cuda.get_sync_debug_mode() == 0
