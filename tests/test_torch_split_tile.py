"""The split-S arithmetic of the bf16 chunk, int8 and paged decode kernels
against the JAX package, on the CPU.

The bf16 chunk kernel (``csrc/chunk_decode_attention.cu``), the int8
decode kernel (``csrc/decode_attention_int8.cu``, single step and chunk)
and the paged kernel (``csrc/paged_attention.cu``, bf16, int8 and int4
pools) cut the cache window into contiguous ranges, one block each,
and merge the ranges' partials (running max, sum of exp, unnormalised
accumulator) the way the JAX package's sequence-parallel decode does.
Their plain version, ``decode_attention_split_plain`` (and
``paged_attention_split_plain`` over a gathered pool), repeats that
arithmetic range by range.  Here it gets the same seeded numpy inputs as:

* the JAX package's ``chunk_decode_attention`` over a bf16 cache, and
  ``decode_attention`` and ``chunk_decode_attention`` with int8 scales
  (the Pallas kernel in interpret mode, as the JAX package's own tests
  run it), for 1, 2, 3 and 7 ranges;
* ``sp_chunk_decode_attention`` with int8 scales on sp meshes of 2 and 4
  CPU devices, where each device holds one range of the cache;
* the JAX paged kernel (``impl=PALLAS_INTERPRET``) over bf16 and int8
  pools, and for int4 pools the ``dequantize_kv_int4`` + attention oracle
  (``impl="xla"``; ROADMAP C-ref-2), over a shuffled table with shared
  blocks and null-block padding.

Every case holds a batch row whose live slots all fall in the first
range (every other range empty) and a fully masked query row, which gives
0 (ROADMAP C-port-2; the JAX oracle of the int4 case gives the uniform
average there, so that row is checked against 0 alone).
``decode_split_plan``'s rule for paged pools (ranges of whole blocks:
``split_len`` a multiple of lcm(128, block size)) and its plan at the
speculative verify's 20 rows are tested beside it.

Tolerances: f32 1e-4 (the same math in another summation order); bf16
2e-2, the port's bf16 attention tolerance (each side rounds p to bf16
relative to another running max and rounds its bf16 output).  A bf16
pool keeps v's type on the port's side whatever q's type (as the dense
path does), so it takes 2e-2 with an f32 q too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.ops import paged_attention as jpa
from bcg_tpu.ops.decode_attention import (
    chunk_decode_attention as j_chunk_decode_attention,
    decode_attention as j_decode_attention,
)
from bcg_tpu.ops.ring_attention import sp_chunk_decode_attention
from bcg_tpu.parallel import build_mesh
from bcg_tpu_torch.models.quantize import quantize_kv_int4
from bcg_tpu_torch.ops import paged_attention as tpa
from bcg_tpu_torch.ops.decode_attention import (
    SPLIT_ITER,
    decode_attention_int8_plain,
    chunk_decode_attention_int8_plain,
    decode_attention_split_plain,
    decode_split_plan,
    quantize_kv,
)
import _torch_jax_obs_state

TOL = {"f32": 1e-4, "bf16": 2e-2}
GROUPS = [(4, 4), (8, 2), (10, 2)]
GROUP_IDS = ["g1", "g4", "g5"]
SPLITS = [1, 2, 3, 7]
SCALE = 128 ** -0.5
FIRST = 40        # row 1's live slots: inside the first range for every count here


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


def _t(x, dt):
    t = torch.from_numpy(np.array(x))
    return t.to(torch.bfloat16) if dt == "bf16" else t


def _j(x, dt):
    a = jnp.asarray(x)
    return a.astype(jnp.bfloat16) if dt == "bf16" else a


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _np(t):
    return t.float().numpy()


def _chunk_mask(rng, B, K, S):
    """[B, K, S]: row 0 random; row 1 live only in its first FIRST slots;
    row 2 with chunk position 1 fully masked."""
    m = rng.random((B, K, S)) < 0.5
    m[1] = False
    m[1, :, :FIRST] = rng.random((K, FIRST)) < 0.7
    m[1, :, 0] = True
    m[2, min(1, K - 1)] = False
    return m


# ------------------------------------------------------------- dense int8

_INT8 = {}


def _int8_case(H, Hkv, K, dt):
    """int8 cache (port quantizer, the same bytes on both sides), q, the
    chunk mask and the JAX Pallas kernel's output (interpret mode),
    computed once for every split count.  K = 0: the single step (q [B,
    H, Dh], mask [B, S])."""
    key = (H, Hkv, K, dt)
    if key not in _INT8:
        B, S, Dh = 3, 300, 128
        rng = np.random.default_rng([H, Hkv, K, len(dt)])
        x = torch.from_numpy(rng.standard_normal((2, B, Hkv, S, Dh)).astype(np.float32))
        vals, sc = quantize_kv(x)
        k8, v8, ks, vs = vals[0].numpy(), vals[1].numpy(), sc[0].numpy(), sc[1].numpy()
        m = _chunk_mask(rng, B, max(K, 1), S)
        q = rng.standard_normal((B, max(K, 1), H, Dh)).astype(np.float32)
        if K == 0:
            q, m = q[:, 0], m[:, 0]
            ref = j_decode_attention(_j(q, dt), jnp.asarray(k8), jnp.asarray(v8), jnp.asarray(m),
                                     SCALE, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
                                     block_s=128, interpret=True)
        else:
            ref = j_chunk_decode_attention(_j(q, dt), jnp.asarray(k8), jnp.asarray(v8),
                                           jnp.asarray(m), SCALE, k_scale=jnp.asarray(ks),
                                           v_scale=jnp.asarray(vs), block_s=128,
                                           interpret=True)
        _INT8[key] = (q, (k8, v8, ks, vs), m, _f32(ref))
    return _INT8[key]


def _port_int8(q, kv, m, dt, n_split, split_len=None):
    k8, v8, ks, vs = (torch.from_numpy(a) for a in kv)
    return decode_attention_split_plain(_t(q, dt), k8, v8, torch.from_numpy(m), SCALE, n_split,
                                        split_len, k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv", GROUPS, ids=GROUP_IDS)
def test_int8_step_split_matches_jax_decode_attention(H, Hkv, dt, n_split):
    q, kv, m, ref = _int8_case(H, Hkv, 0, dt)
    out = _port_int8(q, kv, m, dt, n_split)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), ref, atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K", [4, 5], ids=["ff", "spec"])
@pytest.mark.parametrize("H,Hkv", GROUPS, ids=GROUP_IDS)
def test_int8_chunk_split_matches_jax_chunk_decode_attention(H, Hkv, K, dt, n_split):
    q, kv, m, ref = _int8_case(H, Hkv, K, dt)
    out = _port_int8(q, kv, m, dt, n_split)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), ref, atol=TOL[dt], rtol=TOL[dt])
    assert np.all(_np(out)[2, 1] == 0.0)         # every range empty: 0, not NaN


# ------------------------------------------------------------ dense bf16

_BF16 = {}


def _bf16_chunk_case(H, Hkv, K, dt):
    """A bf16 cache [B, S, Hkv, Dh] (B3a-chunk's layout), q, the chunk
    mask and the JAX Pallas kernel's output (interpret mode), once for
    every split count."""
    key = (H, Hkv, K, dt)
    if key not in _BF16:
        B, S, Dh = 3, 300, 128
        rng = np.random.default_rng([H, Hkv, K, len(dt), 16])
        kv = rng.standard_normal((2, B, S, Hkv, Dh)).astype(np.float32)
        m = _chunk_mask(rng, B, K, S)
        q = rng.standard_normal((B, K, H, Dh)).astype(np.float32)
        ref = j_chunk_decode_attention(_j(q, dt), _j(kv[0], dt), _j(kv[1], dt), jnp.asarray(m),
                                       SCALE, block_s=128, interpret=True)
        _BF16[key] = (q, kv, m, _f32(ref))
    return _BF16[key]


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("K", [4, 5], ids=["ff", "spec"])
@pytest.mark.parametrize("H,Hkv", GROUPS, ids=GROUP_IDS)
def test_bf16_chunk_split_matches_jax_chunk_decode_attention(H, Hkv, K, dt, n_split):
    """B3a-chunk's split arithmetic (K = 4: R = 4 G rows; K = 5, the
    speculative verify: R = 20 at bench-8b's group of 4) against the JAX
    package's bf16 chunk form; a fully masked chunk row gives 0."""
    q, kv, m, ref = _bf16_chunk_case(H, Hkv, K, dt)
    out = decode_attention_split_plain(_t(q, dt), _t(kv[0], dt), _t(kv[1], dt),
                                       torch.from_numpy(m), SCALE, n_split)
    assert out.shape == q.shape
    np.testing.assert_allclose(_np(out), ref, atol=TOL[dt], rtol=TOL[dt])
    assert np.all(_np(out)[2, 1] == 0.0)


@pytest.mark.parametrize("K", [0, 4], ids=["step", "chunk"])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (10, 2)], ids=["g4", "g5"])
def test_int8_split_equals_int8_plain_in_bf16(H, Hkv, K):
    """The split version at the kernel's own range length and the one-shot
    plain version (what the CPU wrapper runs) agree at the bf16
    tolerance."""
    q, kv, m, _ = _int8_case(H, Hkv, K, "bf16")
    split = _port_int8(q, kv, m, "bf16", 3, SPLIT_ITER)
    plain = decode_attention_int8_plain if K == 0 else chunk_decode_attention_int8_plain
    whole = plain(_t(q, "bf16"), *(torch.from_numpy(a) for a in kv), torch.from_numpy(m), SCALE)
    torch.testing.assert_close(split.float(), whole.float(), atol=TOL["bf16"],
                               rtol=TOL["bf16"])


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("K", [1, 5], ids=["step", "spec"])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (10, 2)], ids=["g4", "g5"])
def test_int8_split_matches_sp_chunk_decode_attention(H, Hkv, K, sp):
    """One range per sp device, the JAX package's flash-decoding merge,
    each device dequantizing its own int8 slice.  f32 only: XLA's CPU
    backend cannot run the int8 branch's bf16 x bf16 -> f32 dot."""
    dt = "f32"
    B, S, Dh = 3, 304, 128
    rng = np.random.default_rng([sp, H, K, len(dt)])
    x = torch.from_numpy(rng.standard_normal((2, B, Hkv, S, Dh)).astype(np.float32))
    vals, sc = quantize_kv(x)
    kv = (vals[0].numpy(), vals[1].numpy(), sc[0].numpy(), sc[1].numpy())
    q = rng.standard_normal((B, K, H, Dh)).astype(np.float32)
    m = _chunk_mask(rng, B, K, S)
    m[2] = m[0]
    m[2, :, : S // 2] = False          # live only in the later ranges
    mesh = build_mesh(dp=1, tp=1, sp=sp)
    ref = sp_chunk_decode_attention(_j(q, dt), *(jnp.asarray(a) for a in kv[:2]),
                                    jnp.asarray(m), mesh, scale=SCALE,
                                    k_scale=jnp.asarray(kv[2]), v_scale=jnp.asarray(kv[3]))
    out = _port_int8(q, kv, m, dt, sp, S // sp)
    np.testing.assert_allclose(_np(out), _f32(ref), atol=TOL[dt], rtol=TOL[dt])


# ------------------------------------------------------------------ paged

_PAGED = {}
NBLK, BS = 14, 8


def _pool(rng, layout, N, Hkv, Dh):
    """Pool values of both frameworks from the same numbers: the port's
    entry (torch) and the JAX package's (jnp), block 0 all zeros."""
    x = rng.standard_normal((2, N - 1, BS, Hkv, Dh)).astype(np.float32)
    if layout == "bf16":
        t = torch.zeros((2, N, BS, Hkv, Dh), dtype=torch.bfloat16)
        t[:, 1:] = torch.from_numpy(x).to(torch.bfloat16)
        tentry = {"k": t[0], "v": t[1]}
        jentry = {n: jnp.asarray(_np(tentry[n])).astype(jnp.bfloat16) for n in ("k", "v")}
        return tentry, jentry
    quant = quantize_kv if layout == "int8" else quantize_kv_int4
    vals, sc = quant(torch.from_numpy(x))                 # [2, N-1, BS, Hkv, *], [.., Hkv]
    vals, sc = vals.transpose(2, 3), sc.transpose(2, 3)   # [2, N-1, Hkv, BS, *]
    v_all = torch.zeros((2, N) + tuple(vals.shape[2:]), dtype=vals.dtype)
    s_all = torch.ones((2, N) + tuple(sc.shape[2:]), dtype=sc.dtype)
    v_all[:, 1:], s_all[:, 1:] = vals, sc
    tentry = {"k": v_all[0], "v": v_all[1], "k_scale": s_all[0], "v_scale": s_all[1]}
    jentry = {n: jnp.asarray(tentry[n].numpy()) for n in ("k", "v")}
    for n in ("k_scale", "v_scale"):
        a = jnp.asarray(_np(tentry[n]))
        jentry[n] = a.astype(jnp.bfloat16) if layout == "int4" else a
    return tentry, jentry


def _paged_case(layout, H, Hkv, K, dt):
    """A one-layer pool, a [4, NBLK] table of shuffled blocks (rows 0 and
    1 share their first two blocks, row 2's last three columns are null
    padding), q and the mask, and the JAX reference, computed once for
    every split count.  Row 1 is live only in its first two blocks; row
    3 (step) or row 3's chunk position 1 is fully masked."""
    key = (layout, H, Hkv, K, dt)
    if key not in _PAGED:
        B, Dh = 4, 128
        rng = np.random.default_rng([H, Hkv, K, len(layout), len(dt)])
        N = B * NBLK + 1
        tentry, jentry = _pool(rng, layout, N, Hkv, Dh)
        tbl = (rng.permutation(N - 1)[: B * NBLK] + 1).reshape(B, NBLK).astype(np.int32)
        tbl[1, :2] = tbl[0, :2]
        tbl[2, -3:] = 0
        tentry["tbl"], jentry["tbl"] = torch.from_numpy(tbl), jnp.asarray(tbl)
        S = NBLK * BS
        live = np.repeat(tbl != 0, BS, axis=1)
        m = (rng.random((B, K, S)) < 0.6) & live[:, None]
        m[:, :, 0] = True
        m[1, :, 2 * BS:] = False          # inside the first range for every count here
        m[3, min(1, K - 1)] = False
        q = rng.standard_normal((B, K, H, Dh)).astype(np.float32)
        impl = "xla" if layout == "int4" else jpa.PALLAS_INTERPRET
        if K == 1:
            ref = jpa.paged_decode_attention(_j(q, dt), jentry, jnp.asarray(m[:, 0]), SCALE,
                                             impl=impl)
        else:
            ref = jpa.paged_chunk_attention(_j(q, dt), jentry, jnp.asarray(m), SCALE,
                                            impl=impl)
        _PAGED[key] = (q, tentry, m, _f32(ref))
    return _PAGED[key]


PAGED_FORMS = [(8, 2, 1), (10, 2, 1), (8, 2, 4), (10, 2, 5)]
PAGED_IDS = ["g4-step", "g5-step", "g4-ff", "g5-spec"]


@pytest.mark.parametrize("n_split", SPLITS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("H,Hkv,K", PAGED_FORMS, ids=PAGED_IDS)
@pytest.mark.parametrize("layout", ["bf16", "int8", "int4"])
def test_paged_split_matches_jax_paged_attention(layout, H, Hkv, K, dt, n_split):
    """Ranges of whole pool blocks, as the kernel cuts them."""
    q, tentry, m, ref = _paged_case(layout, H, Hkv, K, dt)
    split_len = -(-NBLK // n_split) * BS
    mask = torch.from_numpy(m[:, 0] if K == 1 else m)
    out = tpa.paged_attention_split_plain(_t(q, dt), tentry, mask, SCALE, n_split, split_len)
    assert out.shape == q.shape
    got = _np(out)
    dead = ~m.any(-1)                                  # [B, K] fully masked query rows
    assert np.all(got[dead] == 0.0)
    tol = TOL["bf16"] if dt == "bf16" or layout == "bf16" else TOL["f32"]
    if layout == "int4":    # the oracle averages a fully masked row uniformly (C-port-2)
        got, ref = got[~dead], ref[~dead]
    np.testing.assert_allclose(got, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("layout", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("K", [1, 4], ids=["step", "chunk"])
def test_paged_split_equals_gather_oracle(layout, K):
    """The split version and the wrapper's plain version (the gather
    oracle the CPU runs) agree, bf16."""
    H, Hkv = 8, 2
    q, tentry, m, _ = _paged_case(layout, H, Hkv, K, "bf16")
    mask = torch.from_numpy(m[:, 0] if K == 1 else m)
    split = tpa.paged_attention_split_plain(_t(q, "bf16"), tentry, mask, SCALE, 3, 5 * BS)
    plain = tpa.paged_decode_attention_plain if K == 1 else tpa.paged_chunk_attention_plain
    whole = plain(_t(q, "bf16"), tentry, mask, SCALE)
    torch.testing.assert_close(split.float(), whole.float(), atol=TOL["bf16"],
                               rtol=TOL["bf16"])


def test_null_block_ranges_weigh_exactly_zero():
    """Every live logit near -100 and the late ranges all null-block
    padding: those ranges weigh exactly 0 (with the -1e30 sentinel an
    empty range's own weight would be exp(0) = 1), so the result is the
    true softmax average, as the JAX paged kernel gives."""
    B, H, Hkv, Dh, N = 2, 4, 2, 128, 9
    rng = np.random.default_rng(5)
    k = np.full((N, BS, Hkv, Dh), -20.0 / np.sqrt(Dh), np.float32)
    k[0] = 0.0
    v = rng.standard_normal((N, BS, Hkv, Dh)).astype(np.float32)
    v[0] = 0.0
    tbl = np.array([[3, 1, 0, 0], [2, 4, 7, 0]], np.int32)
    q = np.full((B, 1, H, Dh), 5.0, np.float32)            # q.k * scale = -100
    m = np.repeat(tbl != 0, BS, axis=1)
    tentry = {"k": torch.from_numpy(k), "v": torch.from_numpy(v), "tbl": torch.from_numpy(tbl)}
    jentry = {"k": jnp.asarray(k), "v": jnp.asarray(v), "tbl": jnp.asarray(tbl)}
    ref = _f32(jpa.paged_decode_attention(jnp.asarray(q), jentry, jnp.asarray(m), SCALE,
                                          impl=jpa.PALLAS_INTERPRET))
    out = tpa.paged_attention_split_plain(torch.from_numpy(q), tentry, torch.from_numpy(m),
                                          SCALE, 4, BS)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(_np(out), ref, atol=TOL["f32"], rtol=TOL["f32"])


# ---------------------------------------------------------------- the plan

def _ranges(S, n, per):
    return [(z * per, S if z == n - 1 else (z + 1) * per) for z in range(n)]


@pytest.mark.parametrize("B,Hkv,S,sms,occ", [
    (10, 8, 5065, 132, 3), (10, 8, 5065, 132, 2), (1, 8, 8191, 132, 3), (3, 2, 1000, 132, 3),
    (2, 2, 129, 132, 3), (1, 1, 300, 4, 2), (33, 8, 5000, 132, 3), (40, 8, 100, 132, 3)])
@pytest.mark.parametrize("bs", [1, 8, 16, 128])
def test_split_plan_is_unchanged_for_blocks_dividing_128(B, Hkv, S, sms, occ, bs):
    """A block size that divides 128 keeps the dense plan."""
    assert decode_split_plan(B, Hkv, S, sms, occ, block_size=bs) == \
        decode_split_plan(B, Hkv, S, sms, occ)


@pytest.mark.parametrize("B,Hkv,nblk,sms,occ", [
    (10, 8, 20, 132, 3), (1, 8, 40, 132, 3), (3, 2, 9, 132, 2), (2, 2, 1, 132, 3),
    (33, 8, 30, 132, 3), (10, 8, 317, 132, 2)])
@pytest.mark.parametrize("bs", [48, 96, 256])
def test_split_plan_cuts_whole_blocks(B, Hkv, nblk, sms, occ, bs):
    """Block sizes that do not divide 128: every range starts on a block
    boundary (split_len a multiple of lcm(128, bs)) and the ranges cover
    exactly [0, S)."""
    S = nblk * bs
    n, per = decode_split_plan(B, Hkv, S, sms, occ, block_size=bs)
    assert per % np.lcm(SPLIT_ITER, bs) == 0 and per % bs == 0
    ranges = _ranges(S, n, per)
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] and a[1] % bs == 0 for a, b in zip(ranges, ranges[1:]))
    assert all(e > a for a, e in ranges)
    if n > 1:
        assert B * Hkv * n <= max(2, occ) * sms


@pytest.mark.parametrize("B,Hkv,S", [(10, 8, 5072), (40, 8, 70000), (1, 1, 300000)])
@pytest.mark.parametrize("bs", [16, 32])
def test_split_plan_caps_the_range_length(B, Hkv, S, bs):
    """``max_len`` bounds every range but a folded last one, which runs
    past it by less than one iteration: the paged kernel's staged table
    range stays within MAX_SPLIT_BLOCKS."""
    max_len = tpa.MAX_SPLIT_BLOCKS * bs - SPLIT_ITER
    n, per = decode_split_plan(B, Hkv, S, 132, 3, block_size=bs, max_len=max_len)
    assert per <= max_len and per % SPLIT_ITER == 0
    longest = max(e - a for a, e in _ranges(S, n, per))
    assert longest < per + SPLIT_ITER
    assert -(-longest // bs) <= tpa.MAX_SPLIT_BLOCKS
    assert _ranges(S, n, per)[-1][1] == S


@pytest.mark.parametrize("S", [3122, 5072, 700, 129])
def test_split_plan_at_the_verify_rows_covers_the_window(S):
    """B3a-chunk at the speculative verify: R = K * G = 20 query rows (two
    m-tiles, two blocks an SM) and Mk = K = 5 mask rows, 10 batch rows
    over 8 kv heads on 132 SMs: contiguous ranges of whole iterations,
    exactly [0, S), one wave of at most two blocks an SM; P3's window
    (~3122 positions) takes more than one split."""
    n, per = decode_split_plan(10, 8, S, 132, 2)
    assert per % SPLIT_ITER == 0 and 10 * 8 * n <= 2 * 132
    ranges = [(z * per, S if z == n - 1 else (z + 1) * per) for z in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(e - a >= min(S, SPLIT_ITER) for a, e in ranges)
    if S >= 3000:
        assert n > 1


def test_split_plan_at_the_bench_paged_shapes():
    """bench-8b's paged forms (B 10, 8 kv heads, blocks of 16 on 132
    SMs): 4 ranges of 1280 at three blocks an SM (R <= 16), 3 at two
    (the speculative chunk's R = 20)."""
    assert decode_split_plan(10, 8, 5072, 132, 3, block_size=16,
                             max_len=tpa.MAX_SPLIT_BLOCKS * 16 - SPLIT_ITER) == (4, 1280)
    assert decode_split_plan(10, 8, 3136, 132, 2, block_size=16) == (3, 1152)
