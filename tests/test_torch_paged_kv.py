"""The block-paged KV cache of the PyTorch port against the JAX package.

* **Host logic.** ``PagedKV`` mirrors ``tests/test_paged_kv.py``'s radix
  index tests (longest full-block match, shared chains, duplicate
  inserts, refcount pins, LRU leaf eviction, stats), and a randomized
  sequence of lookups, inserts, allocations, frees and unpins leaves the
  port's manager and the JAX package's with the same ids, resident,
  free and hit counts at every step.
* **Op.** ``paged_write`` + ``paged_gather_entry`` give the JAX
  package's bytes for the bf16, int8 and int4 pools, at a shared Python
  int, a 0-d tensor and per-row ``[B]`` write positions (the advanced
  index order of a ``[N, Hkv, bs, *]`` pool is numpy's in both).  A
  write into the null block 0 raises on the CPU.  The plain paged decode
  and chunk versions match the Pallas ``_paged_kernel`` in interpret
  mode and the JAX gather oracle (impl ``"xla"``): 1e-5 for f32 q over
  the quantized pools (same dequantized values, another summation
  order), 2e-2 where bf16 rounds the K/V or the probabilities at
  different points; GQA groups 4 and 5 (the JAX wrapper pads 5 to 8),
  several pages, a shuffled table with a shared block and null padding.
* **Model.** Paged prefill, decode steps, a fast-forward chunk and a
  speculative chunk match the JAX package at the ROADMAP C-port-1
  tolerances and leave the same int8 / int4 bytes at every real slot
  (bf16 values within one rounding step, C-port-1); over the
  same contents they are bit-identical to the port's own dense path.
  The suffix prefill over shared prefix blocks and the chunked paged
  prefill (with its carried logits) match JAX too.
* **Engine.** Greedy output of ``TorchEngine`` and ``JaxEngine``, both
  ``paged_kv=True``, is token-identical per row under the plain,
  fast-forward and speculative loops over bf16, int8 and int4 pools,
  with the same decode-step counts and the same ``kv_pool_stats()``
  block counts and hit rates after each of two calls; likewise under
  eviction pressure in a small pool and with chunked prefill.  The null
  block stays zero through every loop; ``paged_kv_impl="xla"`` is
  refused for a CUDA engine.
"""

import dataclasses
import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.engine.paged_kv import PagedKV as JPagedKV, PoolExhausted as JPoolExhausted
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.ops import paged_attention as jpa
from bcg_tpu_torch.engine.paged_kv import PagedKV, PoolExhausted
from bcg_tpu_torch.engine.torch_engine import TorchEngine, _resolve_paged_impl
from bcg_tpu_torch.models import transformer as tt
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.ops import paged_attention as tpa
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
LAYOUTS = ["bf16", "int8", "int4"]
QUANT = {"bf16": False, "int8": "int8", "int4": "int4"}
KV_DTYPE = {"bf16": "bfloat16", "int8": "int8", "int4": "int4"}

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


def _np(x):
    """Storage bytes of a pool leaf as numpy (bf16 as its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# -------------------------------------------------------------- host logic

def _mgr(num_blocks=16, block_size=2):
    return PagedKV(spec_for_model(MODEL), num_blocks, block_size)


class TestRadixIndex:
    def test_lookup_matches_longest_full_block_chain(self):
        mgr = _mgr()
        toks = np.arange(7, dtype=np.int32)  # 3 full blocks + 1 leftover
        assert mgr.lookup(toks) == ([], [])
        ids = mgr.alloc(3)
        mgr.insert([], toks, 0, ids)
        path, blocks = mgr.lookup(toks)
        assert blocks == ids and len(path) == 3
        _, blocks2 = mgr.lookup(np.array([0, 1, 2, 3, 9, 9], dtype=np.int32))
        assert blocks2 == ids[:2]
        mgr.unpin_all()

    def test_shared_chain_between_different_sequences(self):
        mgr = _mgr()
        ids = mgr.alloc(2)
        mgr.insert([], np.array([5, 6, 7, 8], dtype=np.int32), 0, ids)
        b = np.array([5, 6, 1, 2], dtype=np.int32)
        path_b, blocks_b = mgr.lookup(b)
        assert blocks_b == ids[:1]
        mgr.insert(path_b, b, 2, mgr.alloc(1))
        assert mgr.resident_blocks == 3
        mgr.unpin_all()

    def test_duplicate_insert_reuses_node_and_keeps_caller_ownership(self):
        mgr = _mgr()
        toks = np.array([1, 2, 3, 4], dtype=np.int32)
        ids = mgr.alloc(2)
        mgr.insert([], toks, 0, ids)
        dup = mgr.alloc(2)
        grafted = mgr.insert([], toks, 0, dup)
        assert [n.block for n in grafted] == ids
        assert mgr.resident_blocks == 2
        assert all(i not in mgr._free for i in dup)
        mgr.free(dup)
        mgr.unpin_all()

    def test_refcount_pin_blocks_eviction_mid_call(self):
        mgr = _mgr(num_blocks=6, block_size=2)  # 5 usable
        toks = np.array([1, 2, 3, 4], dtype=np.int32)
        ids = mgr.alloc(2)
        mgr.insert([], toks, 0, ids)  # insert pins the grafted path
        with pytest.raises(PoolExhausted):
            mgr.alloc(5)
        assert mgr.resident_blocks == 2
        assert mgr.lookup(toks)[1] == ids
        mgr.unpin_all()
        assert len(mgr.alloc(5)) == 5
        assert mgr.resident_blocks == 0

    def test_eviction_is_lru_and_leaf_only(self):
        mgr = _mgr(num_blocks=8, block_size=2)
        a, b = np.array([1, 2, 3, 4], np.int32), np.array([9, 9], np.int32)
        ids_a = mgr.alloc(2)
        mgr.insert([], a, 0, ids_a)
        mgr.insert([], b, 0, mgr.alloc(1))
        mgr.unpin_all()
        mgr.lookup(a)                       # a's chain is now the most recent
        mgr.unpin_all()
        assert mgr.evict(1) == 1
        assert mgr.lookup(b)[1] == []      # b (LRU leaf) went first
        assert mgr.evict(1) == 1            # then a's leaf, never its interior first
        assert mgr.lookup(a)[1] == ids_a[:1]
        mgr.unpin_all()

    def test_stats_surface_and_null_block(self):
        mgr = _mgr(num_blocks=8, block_size=2)
        toks = np.array([1, 2, 3, 4], dtype=np.int32)
        mgr.lookup(toks)
        mgr.insert([], toks, 0, mgr.alloc(2))
        mgr.unpin_all()
        mgr.lookup(toks)
        mgr.unpin_all()
        s = mgr.stats()
        assert (s["blocks_total"], s["blocks_resident"], s["blocks_free"]) == (7, 2, 5)
        assert s["free_block_headroom_bytes"] == 5 * mgr.block_bytes_dev
        assert s["prefix_hit_rate"] == 0.5
        mgr.free([0])
        assert 0 not in mgr._free and 0 not in mgr.alloc(5)

    def test_invalidate_zeroes_pool_and_forgets_the_tree(self):
        mgr = PagedKV(spec_for_model(MODEL), 6, 2, quantized="int4")
        mgr.pool[0]["k"].fill_(3)
        mgr.pool[1]["v_scale"].fill_(2)
        mgr.insert([], np.array([1, 2], np.int32), 0, mgr.alloc(1))
        mgr.invalidate()
        assert mgr.resident_blocks == 0 and mgr.free_blocks() == 5
        assert all(torch.all(e["k"] == 0) and torch.all(e["v_scale"] == 1) for e in mgr.pool)

    def test_same_decisions_as_the_jax_manager(self):
        """A seeded random sequence of manager calls, applied to both
        managers, returns the same ids and leaves the same counts."""
        rng = np.random.default_rng(4)
        jm = JPagedKV(j_spec(MODEL), 24, 2)
        tm = PagedKV(spec_for_model(MODEL), 24, 2)
        vocab = np.array([1, 2, 3], np.int32)
        for _ in range(300):
            op = rng.integers(0, 5)
            toks = rng.choice(vocab, size=int(rng.integers(0, 9)))
            if op == 0:
                (jp, jb), (tp, tb) = jm.lookup(toks), tm.lookup(toks)
                assert jb == tb
                n = len(toks) // 2 - len(jb)
                if n > 0 and rng.random() < 0.7:
                    try:
                        ja = jm.alloc(n)
                    except JPoolExhausted:
                        with pytest.raises(PoolExhausted):
                            tm.alloc(n)
                        continue
                    assert tm.alloc(n) == ja
                    jg = jm.insert(jp, toks, 2 * len(jb), ja)
                    tg = tm.insert(tp, toks, 2 * len(tb), ja)
                    assert [g.block for g in jg] == [g.block for g in tg]
            elif op == 1:
                jm.unpin_all()
                tm.unpin_all()
            elif op == 2:
                n = int(rng.integers(1, 6))
                assert jm.evict(n) == tm.evict(n)
            elif op == 3 and jm.free_blocks() > 2:
                ids = jm.alloc(2)
                assert tm.alloc(2) == ids
                jm.free(ids)
                tm.free(ids)
            assert {k: tm.stats()[k] for k in STAT_KEYS} == {k: jm.stats()[k] for k in STAT_KEYS}
        assert jm.resident_blocks > 0


# The paged pool's telemetry (ROADMAP C-port-7): gauges, counters.
KVPOOL_GAUGES = ("kvpool.blocks_total", "kvpool.blocks_free", "kvpool.blocks_resident",
                 "kvpool.headroom_bytes")
KVPOOL_COUNTERS = ("kvpool.evicted_blocks", "kvpool.hit_positions", "kvpool.lookup_positions")


def _kvpool(counters, before):
    """The ``kvpool.*`` gauges, and the counters' movement since
    ``before`` (the registries are process-wide)."""
    snap = counters.snapshot()
    return ({g: snap.get(g, 0) for g in KVPOOL_GAUGES},
            {c: snap.get(c, 0) - before.get(c, 0) for c in KVPOOL_COUNTERS})


def test_kvpool_telemetry_equals_the_jax_pools():
    """C-port-7: a seeded sequence of allocations, prefix lookups and
    inserts (hits), frees and evictions, applied to both managers, leaves
    the same ``kvpool.*`` gauges and counter movements after every step;
    ``close()`` zeroes the gauges of both."""
    from bcg_tpu.obs import counters as j_counters
    from bcg_tpu_torch.obs import counters as t_counters

    rng = np.random.default_rng(7)
    jb, tb = j_counters.snapshot(), t_counters.snapshot()
    jm = JPagedKV(j_spec(MODEL), 16, 2)
    tm = PagedKV(spec_for_model(MODEL), 16, 2)
    assert _kvpool(t_counters, tb)[0]["kvpool.blocks_total"] == 15
    vocab = np.array([1, 2, 3], np.int32)
    moved = set()
    for _ in range(200):
        op = rng.integers(0, 4)
        toks = rng.choice(vocab, size=int(rng.integers(0, 9)))
        if op == 0:
            (jp, jbl), (tp, tbl) = jm.lookup(toks), tm.lookup(toks)
            n = len(toks) // 2 - len(jbl)
            if n > 0:
                try:
                    ids = jm.alloc(n)
                except JPoolExhausted:
                    with pytest.raises(PoolExhausted):
                        tm.alloc(n)
                    continue
                assert tm.alloc(n) == ids
                jm.insert(jp, toks, 2 * len(jbl), ids)
                tm.insert(tp, toks, 2 * len(tbl), ids)
        elif op == 1:
            jm.unpin_all()
            tm.unpin_all()
        elif op == 2:
            n = int(rng.integers(1, 6))
            assert jm.evict(n) == tm.evict(n)
        elif jm.free_blocks() > 2:
            ids = jm.alloc(2)
            assert tm.alloc(2) == ids
            jm.free(ids)
            tm.free(ids)
        got, want = _kvpool(t_counters, tb), _kvpool(j_counters, jb)
        assert got == want
        moved |= {k for k, v in got[1].items() if v}
    assert moved == set(KVPOOL_COUNTERS)
    jm.close()
    tm.close()
    assert _kvpool(t_counters, tb)[0] == _kvpool(j_counters, jb)[0] == dict.fromkeys(
        KVPOOL_GAUGES, 0)


def test_kvpool_alloc_chaos_seam_injects_like_the_jax_pools(monkeypatch):
    """C-port-7: ``BCG_TPU_CHAOS=exhaust@kvpool.alloc`` raises
    ``PoolExhausted`` at the first allocation of either package's pool
    (nothing taken off the free list), counted as an injected fault, and
    the next allocation goes through."""
    from bcg_tpu.runtime import resilience as j_resilience
    from bcg_tpu_torch.runtime import resilience as t_resilience

    monkeypatch.setenv("BCG_TPU_CHAOS", "exhaust@kvpool.alloc:1")
    j_resilience.reset()
    t_resilience.reset()
    try:
        for mgr, exc, res in ((JPagedKV(j_spec(MODEL), 8, 2), JPoolExhausted, j_resilience),
                              (PagedKV(spec_for_model(MODEL), 8, 2), PoolExhausted,
                               t_resilience)):
            with pytest.raises(exc, match="chaos"):
                mgr.alloc(1)
            assert mgr.free_blocks() == 7
            assert res.stats() == {"exhaust@kvpool.alloc": 1}
            assert mgr.alloc(1) == [1]
    finally:
        monkeypatch.delenv("BCG_TPU_CHAOS")
        j_resilience.reset()
        t_resilience.reset()


# --------------------------------------------------------------------- op

def _pools(layout, Hkv, Dh, N=20, bs=8):
    """One-layer pools of both frameworks for ``layout``."""
    jspec = dataclasses.replace(j_spec(MODEL), num_layers=1, num_kv_heads=Hkv,
                                num_heads=Hkv, head_dim=Dh)
    tspec = SimpleNamespace(num_layers=1, num_kv_heads=Hkv, head_dim=Dh)
    return (jpa.init_block_pool(jspec, N, bs, quantized=QUANT[layout])[0],
            tpa.init_block_pool(tspec, N, bs, quantized=QUANT[layout])[0])


def _assert_pool_equal(jentry, tentry):
    for name in ("k", "v", "k_scale", "v_scale"):
        if name in tentry:
            assert np.array_equal(_np(tentry[name]), _np(jentry[name])), name


@pytest.mark.parametrize("pos_kind", ["int", "0-d", "rows"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_write_and_gather_match_jax_bytes(layout, pos_kind):
    rng = np.random.default_rng([len(layout), len(pos_kind)])
    B, T, Hkv, Dh, bs = 3, 5, 2, 128, 8
    jentry, tentry = _pools(layout, Hkv, Dh, bs=bs)
    tbl = np.array([[3, 7, 1, 0], [12, 2, 5, 0], [9, 4, 18, 6]], np.int32)
    jentry["tbl"], tentry["tbl"] = jnp.asarray(tbl), torch.from_numpy(tbl)
    pos = {"int": 6, "0-d": np.int32(6), "rows": np.array([6, 11, 19], np.int32)}[pos_kind]
    for step in range(2):
        k = (rng.standard_normal((B, T, Hkv, Dh)) * 3).astype(np.float32)
        v = rng.standard_normal((B, T, Hkv, Dh)).astype(np.float32)
        k[0, 1] = 0.0                                  # an all-zero row: scale 1
        p = pos + step * T
        jentry = jpa.paged_write(jentry, jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(p) if pos_kind != "int" else p)
        tp = torch.from_numpy(np.asarray(p)) if pos_kind != "int" else p
        tpa.paged_write(tentry, torch.from_numpy(k), torch.from_numpy(v), tp)
    _assert_pool_equal(jentry, tentry)
    assert torch.all(tentry["k"][0] == 0)              # the null block is untouched
    for upto in (0, 2):
        jg = jpa.paged_gather_entry(jentry, upto_blocks=upto)
        tg = tpa.paged_gather_entry(tentry, upto_blocks=upto)
        assert set(jg) == set(tg)
        _assert_pool_equal(jg, tg)


@pytest.mark.parametrize("layout", ["int8", "int4"])
def test_write_lands_at_block_then_head_then_offset(layout):
    """``pool[blk, :, off] = kq`` on a ``[N, Hkv, bs, *]`` pool: the
    advanced indices go first, so row b's token t lands at
    ``pool[blk[b, t], :, off[b, t]]`` with its heads along dim 1."""
    jentry, tentry = _pools(layout, 2, 128, bs=4)
    tentry["tbl"] = torch.tensor([[0, 5, 9], [0, 2, 11]], dtype=torch.int32)
    k = torch.randn(2, 2, 2, 128)
    tpa.paged_write(tentry, k, k, torch.tensor([5, 10]))
    quant = tt._kv_quantizer(tentry)
    kq, ksc = quant(k)
    for b, t, blk, off in [(0, 0, 5, 1), (0, 1, 5, 2), (1, 0, 11, 2), (1, 1, 11, 3)]:
        assert torch.equal(tentry["k"][blk, :, off], kq[b, t])
        assert torch.equal(tentry["k_scale"][blk, :, off], ksc[b, t])


def test_write_into_the_null_block_raises():
    _, tentry = _pools("bf16", 2, 128, bs=4)
    tentry["tbl"] = torch.tensor([[0, 3]], dtype=torch.int32)
    with pytest.raises(RuntimeError, match="null block"):
        tpa.paged_write(tentry, torch.ones(1, 2, 2, 128), torch.ones(1, 2, 2, 128), 3)
    assert torch.all(tentry["k"] == 0)


def _attention_case(layout, H, Hkv, K, seed):
    """Pools of both frameworks filled by ``paged_write`` from the same
    numbers, a 6-column table per row (row 1 shares row 0's first block;
    each row's last column is null padding) and a mask live on the real
    blocks only, never empty per query row."""
    rng = np.random.default_rng(seed)
    B, Dh, bs, nblk = 2, 128, 8, 6
    jentry, tentry = _pools(layout, Hkv, Dh, N=16, bs=bs)
    tbl = np.array([[4, 9, 1, 13, 7, 0], [4, 2, 15, 11, 3, 0]], np.int32)
    S = nblk * bs
    for rows, t in ((np.array([0]), tbl[:1]), (np.array([1]), tbl[1:])):
        x = rng.standard_normal((2, 1, S - bs, Hkv, Dh)).astype(np.float32)
        if rows[0] == 1:                               # keep the shared block as row 0 wrote it
            x = x[:, :, bs:]
        start = 0 if rows[0] == 0 else bs
        jentry = jpa.paged_write({**jentry, "tbl": jnp.asarray(t)}, jnp.asarray(x[0]),
                                 jnp.asarray(x[1]), start)
        tpa.paged_write({**tentry, "tbl": torch.from_numpy(t)}, torch.from_numpy(x[0]),
                        torch.from_numpy(x[1]), start)
    jentry["tbl"], tentry["tbl"] = jnp.asarray(tbl), torch.from_numpy(tbl)
    live = np.repeat(tbl != 0, bs, axis=1)
    m = (rng.random((B, K, S)) < 0.6) & live[:, None]
    m[:, :, 0] = True
    q = rng.standard_normal((B, K, H, Dh)).astype(np.float32)
    return jentry, tentry, q, m


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["step", "chunk"])
@pytest.mark.parametrize("H,Hkv", [(8, 2), (10, 2)], ids=["g4", "g5"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_paged_attention_matches_pallas_kernel_and_gather_oracle(layout, H, Hkv, form,
                                                                        bf16):
    K = 1 if form == "step" else 4
    jentry, tentry, q, m = _attention_case(layout, H, Hkv, K, [H, K, len(layout), int(bf16)])
    qj = jnp.asarray(q).astype(jnp.bfloat16) if bf16 else jnp.asarray(q)
    qt = torch.from_numpy(q).to(torch.bfloat16) if bf16 else torch.from_numpy(q)
    scale = 128 ** -0.5
    if form == "step":
        args = (jnp.asarray(m[:, 0]), torch.from_numpy(m[:, 0]))
        jfn, tfn = jpa.paged_decode_attention, tpa.paged_decode_attention
    else:
        args = (jnp.asarray(m), torch.from_numpy(m))
        jfn, tfn = jpa.paged_chunk_attention, tpa.paged_chunk_attention
    kern = jfn(qj, jentry, args[0], scale, impl=jpa.PALLAS_INTERPRET)
    oracle = jfn(qj, jentry, args[0], scale, impl="xla")
    calls = tpa.paged_decode_attention_plain.calls + tpa.paged_chunk_attention_plain.calls
    out = tfn(qt, tentry, args[1], scale)
    assert tpa.paged_decode_attention_plain.calls + tpa.paged_chunk_attention_plain.calls \
        == calls + 1                                   # CPU: the plain version
    assert out.shape == (2, K, H, 128)
    # An f32 q over a quantized pool: the same dequantized f32 values on
    # both sides.  A bf16 pool keeps v's type, as the port's dense path
    # does (probabilities and output in bf16; the Pallas kernel casts K/V
    # up to q's type), and a bf16 q rounds the dequantized K/V and the
    # probabilities at different points: bf16 tolerance for both.
    tol = 2e-2 if bf16 or layout == "bf16" else 1e-5
    for ref in (kern, oracle):
        np.testing.assert_allclose(out.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


def test_plain_gives_zero_for_a_fully_masked_row():
    """C-port-2: a row with no live key gives 0, as the Pallas kernel's
    ``l == 0`` guard does."""
    jentry, tentry, q, m = _attention_case("int4", 8, 2, 4, 9)
    m[1, 2] = False
    out = tpa.paged_chunk_attention(torch.from_numpy(q), tentry, torch.from_numpy(m), 0.1)
    kern = jpa.paged_chunk_attention(jnp.asarray(q), jentry, jnp.asarray(m), 0.1,
                                     impl=jpa.PALLAS_INTERPRET)
    assert torch.all(out[1, 2] == 0) and np.all(np.asarray(kern)[1, 2] == 0)


# ------------------------------------------------------------------ model

def _setup(seed):
    jspec, spec = j_spec(MODEL), spec_for_model(MODEL)
    jp = jt.init_params(jspec, jax.random.PRNGKey(seed), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec, "cpu", torch.float32)
    return jspec, spec, jp, tp


def _model_pools(jspec, spec, layout, tbl):
    N = int(tbl.max()) + 3
    jpool = jpa.init_block_pool(jspec, N, 8, quantized=QUANT[layout])
    tpool = tpa.init_block_pool(spec, N, 8, quantized=QUANT[layout])
    return ([{**e, "tbl": jnp.asarray(tbl)} for e in jpool],
            [{**e, "tbl": torch.from_numpy(tbl)} for e in tpool])


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                               atol=tol, rtol=tol)


def _assert_entries_equal(tc, jc, real, bs):
    """Pool contents of every layer at the real (written, attendable)
    logical slots ``real`` [B, S] of each row: int8 / int4 bytes equal,
    their scales within f32 rounding (ROADMAP C-port-3); bf16 values
    within one bf16 step (C-port-1)."""
    tbl = np.asarray(jc[0]["tbl"])
    for li in range(len(tc)):
        tg = tpa.paged_gather_entry(tc[li])
        jg = jpa.paged_gather_entry(jc[li])
        for n in ("k", "v"):
            if "k_scale" not in tg:
                # bf16 values: within one bf16 rounding step (C-port-1: the
                # f32 projections differ by ulps between the frameworks).
                t = tg[n].float().numpy()[real]
                j = np.asarray(jg[n].astype(jnp.float32))[real]
                np.testing.assert_allclose(t, j, rtol=2 ** -7, atol=1e-6)
                continue
            t, j = _np(tg[n]).transpose(0, 2, 1, 3), _np(jg[n]).transpose(0, 2, 1, 3)
            assert np.array_equal(t[real], j[real]), (li, n)
            if "k_scale" in tg:
                ts = tg[f"{n}_scale"].float().numpy().transpose(0, 2, 1)[real]
                js = np.asarray(jg[f"{n}_scale"].astype(jnp.float32)).transpose(0, 2, 1)[real]
                np.testing.assert_allclose(ts, js, rtol=1e-5, atol=0)
    assert tbl.shape[1] * bs == real.shape[1]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_prefill_decode_and_chunks_match_jax_and_dense(layout):
    """Right-padded paged prefill, three decode steps, a fast-forward chunk
    at a 0-d write slot and a speculative chunk at per-row slots: logits
    match JAX, the pools hold the same bytes at every real slot, and a
    dense cache run over the same slots gives bit-identical logits."""
    jspec, spec, jp, tp = _setup(seed=2)
    rng = np.random.RandomState(5)
    B, L, bs, nblk = 3, 20, 8, 6
    S = nblk * bs
    tokens = rng.randint(0, 256, (B, L)).astype(np.int32)
    valid = np.ones((B, L), bool)
    valid[1, 15:] = False                               # right padding
    valid[2, 9:] = False
    tbl = np.array([[5, 1, 9, 3, 11, 7], [2, 14, 6, 8, 12, 10], [13, 4, 15, 16, 17, 18]],
                   np.int32)
    jc, tc = _model_pools(jspec, spec, layout, tbl)
    P0 = np.zeros((B, 0), bool)
    z = np.zeros((B,), np.int32)
    jl, jc = jt.prefill_paged(jp, jspec, jnp.asarray(tokens), jnp.asarray(valid), jc,
                              jnp.asarray(P0), jnp.asarray(z))
    tl, tc = tt.prefill_paged(tp, spec, torch.from_numpy(tokens).long(),
                              torch.from_numpy(valid), tc, torch.from_numpy(P0),
                              torch.from_numpy(z))
    _close(tl, jl, 1e-4)
    dense = tt.init_kv_cache(spec, B, S, torch.bfloat16, quantized=QUANT[layout])
    full = np.ones((B, L), bool)
    dl, dense = tt.prefill(tp, spec, torch.from_numpy(tokens).long(), torch.from_numpy(full),
                           dense)
    tl_full, _ = tt.prefill_paged(tp, spec, torch.from_numpy(tokens).long(),
                                  torch.from_numpy(full), _model_pools(jspec, spec, layout,
                                                                       tbl)[1],
                                  torch.from_numpy(P0), torch.from_numpy(z))
    assert torch.equal(tl_full, dl)
    vm = np.zeros((B, S), bool)
    vm[:, :L] = valid
    vmd = np.zeros((B, S), bool)
    vmd[:, :L] = True
    lens = valid.sum(1).astype(np.int32)
    steps = rng.randint(0, 256, (3, B)).astype(np.int32)
    for i in range(3):
        vm[:, L + i] = True
        vmd[:, L + i] = True
        jl, jc = jt.decode_step(jp, jspec, jnp.asarray(steps[i]), jnp.int32(L + i),
                                jnp.asarray(lens + i), jc, jnp.asarray(vm))
        tl, tc = tt.decode_step(tp, spec, torch.from_numpy(steps[i]).long(), L + i,
                                torch.from_numpy(lens + i), tc, torch.from_numpy(vm))
        _close(tl, jl, DECODE_TOL_F32)
    # Fast-forward chunk, K = 4, at a 0-d write slot.
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
    # Speculative chunk, K1 = 5, at per-row slots.
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
    _assert_entries_equal(tc, jc, vm, bs)
    assert all(torch.all(e["k"][0] == 0) for e in tc)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_decode_bit_identical_to_dense_over_the_same_contents(layout):
    """Decode steps and chunks over a paged pool and over a dense cache
    holding the same contents give bit-identical logits: the plain paged
    version is the gather, then the dense plain attention."""
    _, spec, _, tp = _setup(seed=4)
    rng = np.random.RandomState(1)
    B, L, bs, nblk = 2, 16, 8, 5
    S = nblk * bs
    tokens = rng.randint(0, 256, (B, L))
    full = torch.ones((B, L), dtype=torch.bool)
    tbl = np.array([[3, 8, 1, 6, 9], [2, 7, 4, 10, 5]], np.int32)
    _, tc = _model_pools(j_spec(MODEL), spec, layout, tbl)
    dense = tt.init_kv_cache(spec, B, S, torch.bfloat16, quantized=QUANT[layout])
    z = torch.zeros((B,), dtype=torch.int32)
    lp, tc = tt.prefill_paged(tp, spec, torch.from_numpy(tokens), full, tc,
                              torch.zeros((B, 0), dtype=torch.bool), z)
    ld, dense = tt.prefill(tp, spec, torch.from_numpy(tokens), full, dense)
    assert torch.equal(lp, ld)
    vm = torch.zeros((B, S), dtype=torch.bool)
    vm[:, :L] = True
    for i in range(3):
        vm[:, L + i] = True
        tok = torch.argmax(ld, -1)
        lp, tc = tt.decode_step(tp, spec, tok, L + i, torch.full((B,), L + i), tc, vm)
        ld, dense = tt.decode_step(tp, spec, tok, L + i, torch.full((B,), L + i), dense, vm)
        assert torch.equal(lp, ld)
    chunk = torch.from_numpy(rng.randint(0, 256, (B, 4)))
    cv = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1]], dtype=torch.bool)
    pos = (L + 3) + torch.arange(4)[None].expand(B, 4)
    lp, tc = tt.decode_chunk(tp, spec, chunk, cv, torch.tensor(L + 3), pos, tc, vm)
    ld, dense = tt.decode_chunk(tp, spec, chunk, cv, torch.tensor(L + 3), pos, dense, vm)
    assert torch.equal(lp, ld)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_suffix_and_chunked_prefill_match_jax(layout):
    """A suffix prefill over radix-shared prefix blocks (both rows' tables
    start with the same two blocks), then the same suffix again as a
    chunked prefill (chunk 8, carried logits): logits match JAX.  (The
    chunked logits differ from the one-pass ones in both frameworks:
    later chunks read earlier chunks' KV as stored in the pool.)"""
    jspec, spec, jp, tp = _setup(seed=3)
    rng = np.random.RandomState(2)
    B, bs, P, Ls = 2, 8, 16, 20
    ptok = rng.randint(0, 256, (1, P)).astype(np.int32)
    tbl = np.array([[1, 2, 3, 4, 5, 6, 0], [1, 2, 7, 8, 9, 10, 0]], np.int32)
    jc, tc = _model_pools(jspec, spec, layout, tbl)
    one = np.ones((1, P), bool)
    z1, P0 = np.zeros((1,), np.int32), np.zeros((1, 0), bool)
    jc1 = [{**e, "tbl": e["tbl"][:1]} for e in jc]
    _, jc1 = jt.prefill_paged(jp, jspec, jnp.asarray(ptok), jnp.asarray(one), jc1,
                              jnp.asarray(P0), jnp.asarray(z1))
    jc = [{**e, "tbl": jnp.asarray(tbl)} for e in jc1]
    tt.prefill_paged(tp, spec, torch.from_numpy(ptok).long(), torch.from_numpy(one),
                     [{**e, "tbl": e["tbl"][:1]} for e in tc], torch.from_numpy(P0),
                     torch.from_numpy(z1))
    stok = rng.randint(0, 256, (B, Ls)).astype(np.int32)
    svalid = np.ones((B, Ls), bool)
    svalid[1, 13:] = False
    pv = np.ones((B, P), bool)
    plens = np.full((B,), P, np.int32)
    jl, _ = jt.prefill_paged(jp, jspec, jnp.asarray(stok), jnp.asarray(svalid), jc,
                             jnp.asarray(pv), jnp.asarray(plens))
    tl, _ = tt.prefill_paged(tp, spec, torch.from_numpy(stok).long(), torch.from_numpy(svalid),
                             tc, torch.from_numpy(pv), torch.from_numpy(plens))
    _close(tl, jl, 1e-4)
    # The same suffix in chunks of C = 8 over a block-aligned window of 24.
    C, Lw = 8, 24
    tok_w = np.pad(stok, ((0, 0), (0, Lw - Ls)))
    val_w = np.pad(svalid, ((0, 0), (0, Lw - Ls)))
    jlog = jnp.zeros((B, spec.vocab_size), jnp.float32)
    tlog = torch.zeros((B, spec.vocab_size))
    for start in range(0, Lw, C):
        H = P + Lw - C
        hist = np.zeros((B, H), bool)
        hist[:, :P] = True
        hist[:, P:P + start] = val_w[:, :start]
        off = (plens + val_w[:, :start].sum(1)).astype(np.int32)
        sl = slice(start, start + C)
        jlog, jc = jt.prefill_paged_chunk_at(
            jp, jspec, jnp.asarray(tok_w[:, sl]), jnp.asarray(val_w[:, sl]), jc,
            jnp.asarray(hist), jnp.asarray(off), jnp.int32(P + start), jlog)
        tlog, tc = tt.prefill_paged_chunk_at(
            tp, spec, torch.from_numpy(tok_w[:, sl]).long(), torch.from_numpy(val_w[:, sl]), tc,
            torch.from_numpy(hist), torch.from_numpy(off), P + start, tlog)
        _close(tlog, jlog, 1e-4)
        if start == 8:
            row1 = tlog[1].clone()
    # Row 1's last valid token sits in chunk 1: chunk 2 carries its logits.
    assert torch.equal(tlog[1], row1)


# ----------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def params():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


PROMPTS = [
    (f"You are agent_{i % 2}. Reach consensus with the others. " * 2,
     f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
     DECISION if i % 2 else VOTE)
    for i in range(4)
]
PROMPTS2 = [(s, u + " Round 2: the others said 14.", sch) for s, u, sch in PROMPTS]


def _engines(params, **kw):
    jp, tp = params
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        je = JaxEngine(jcfg.EngineConfig(backend="jax", model_name=MODEL, max_model_len=2048,
                                         paged_kv=True, **kw), params=jp)
    te = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048,
                                       paged_kv=True, **kw), device="cpu", params=tp)
    return je, te


STAT_KEYS = ("blocks_total", "blocks_resident", "blocks_free", "prefix_hit_rate")


def _same_calls(je, te, calls, max_tokens=48):
    for prompts in calls:
        a = je.batch_generate_json(prompts, temperature=0.0, max_tokens=max_tokens)
        b = te.batch_generate_json(prompts, temperature=0.0, max_tokens=max_tokens)
        assert b == a
        assert all("error" not in r for r in b)
        assert te.last_decode_steps == je.last_decode_steps
        js, ts = je.kv_pool_stats(), te.kv_pool_stats()
        assert {k: ts[k] for k in STAT_KEYS} == {k: js[k] for k in STAT_KEYS}
    for e in te._paged.pool:                            # the null block stayed zero
        assert torch.all(e["k"][0] == 0) and torch.all(e["v"][0] == 0)


@pytest.mark.parametrize("loop", [{}, dict(decode_fast_forward=True), dict(spec_decode=True)],
                         ids=["plain", "ff", "spec"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_paged_engine_greedy_identical_to_jax(params, layout, loop):
    je, te = _engines(params, kv_cache_dtype=KV_DTYPE[layout], **loop)
    _same_calls(je, te, [PROMPTS, PROMPTS2])
    ts = te.kv_pool_stats()
    assert ts["prefix_hit_rate"] > 0 and ts["kv_dtype"] == KV_DTYPE[layout]
    assert ts["impl"] == "plain" and ts["pages_per_program"] is None
    je.shutdown()
    te.shutdown()
    assert te._paged is None


def test_small_pool_eviction_parity(params):
    """A pool of 80 blocks of 16 tokens: the second call evicts radix
    leaves of the first, in the same order on both engines."""
    je, te = _engines(params, kv_pool_blocks=80)
    other = [(f"You are observer_{i}. Watch closely. " * 3, u, s) for i, (_, u, s) in
             enumerate(PROMPTS)]
    _same_calls(je, te, [PROMPTS, other, PROMPTS2])
    assert te.kv_pool_stats()["blocks_free"] < 80


def test_paged_chunked_prefill_identical_to_jax(params):
    je, te = _engines(params, prefill_chunk=20, kv_cache_dtype="int8")
    assert te.prefill_chunk == je.prefill_chunk == 32     # aligned up to the block size
    _same_calls(je, te, [PROMPTS])


def test_paged_free_generation_identical_to_jax(params):
    """Unguided generation takes the paged path with no cached prefix:
    the whole prompt prefills into private blocks."""
    je, te = _engines(params, kv_cache_dtype="int4")
    prompts = ["Count to five:", "The agents agree on"]
    a = je.batch_generate(prompts, temperature=0.0, max_tokens=12)
    b = te.batch_generate(prompts, temperature=0.0, max_tokens=12)
    assert b == a
    assert te.kv_pool_stats()["blocks_resident"] == je.kv_pool_stats()["blocks_resident"] == 0


def test_admission_counts_blocks(params):
    _, tp = params
    te = TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048,
                                       paged_kv=True, kv_pool_blocks=400), device="cpu",
                     params=tp)
    usable = 400 - 1 - te._paged_scratch_reserve()
    assert te._paged_usable_blocks() == usable
    assert te.cap_for(1024) == usable // 64
    # Worst case first (2048 slots), then the prompt's own bucket (512)
    # plus the decode tail (1001 slots).
    assert te._provisioned_row_cap([("a", "", "b")] * 8, [1000] * 8) \
        == usable // -(-(512 + 1001) // 16)
    with pytest.warns(UserWarning, match="paged pool"):
        te._check_kv_budget(16, [8], 200)
    assert te.kv_pool_stats()["scratch_reserve_blocks"] == te._paged_scratch_blocks


def test_paged_impl_resolution():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert _resolve_paged_impl("auto", cuda) == _resolve_paged_impl("pallas", cuda) == "cuda"
    with pytest.raises(ValueError, match="xla"):
        _resolve_paged_impl("xla", cuda)
    assert {_resolve_paged_impl(v, cpu) for v in ("auto", "pallas", "xla")} == {"plain"}
    with pytest.raises(ValueError, match="expected"):
        _resolve_paged_impl("gather", cpu)


def test_paged_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device rule is for CPU hosts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL, paged_kv=True))
