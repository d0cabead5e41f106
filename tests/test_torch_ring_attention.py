"""``bcg_tpu_torch.ops.ring_attention`` against the JAX package's
``ops/ring_attention.py`` on the same numpy inputs.

The port's functions take a rank's local shards and talk over
``torch.distributed``; here they run in a gloo world of 2 ranks (sp 2) and
one of 4 (tp x sp 2 x 2), started once for the module
(``tests/_torch_parallel_worker.ring_cases``), and their shards are put
back together.  The JAX functions run on the conftest's virtual CPU
devices over meshes of the same shape.  The cases are those of
``tests/test_parallel.py``'s ring and sp-decode classes: causal and
non-causal, a ``kv_valid`` mask, strongly negative logits over empty
shards, int8 local dequantization, chunk queries, and indivisible lengths
raising.

Tolerances: f32 inputs at 1e-5 (both sides accumulate in f32); bf16 inputs
at 2e-2 (one bf16 rounding of the probabilities and of the output).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bcg_tpu.ops import ring_attention as jra
from bcg_tpu.ops.decode_attention import quantize_kv as j_quantize_kv
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu_torch.parallel.distributed import spawn_world
import _torch_jax_obs_state

TESTS = os.path.dirname(os.path.abspath(__file__))
TOL = {"f32": 1e-5, "bf16": 2e-2}
WORLD_LIMIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


def _cases():
    """(spec, arrays) of every case, from numpy seeds."""
    rng = np.random.default_rng(0)
    cases = []

    def add(spec, **arrays):
        cases.append((spec, arrays))

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    B, T, H, Hkv, Dh = 2, 32, 4, 2, 16
    for dt in ("f32", "bf16"):
        add(dict(name=f"ring_causal_{dt}", fn="ring", causal=True, dtype=dt),
            q=normal(B, T, H, Dh), k=normal(B, T, Hkv, Dh), v=normal(B, T, Hkv, Dh))
    add(dict(name="ring_noncausal_f32", fn="ring", causal=False, dtype="f32"),
        q=normal(B, T, H, Dh), k=normal(B, T, Hkv, Dh), v=normal(B, T, Hkv, Dh))
    valid = np.arange(T)[None, :] >= np.array([5, 20])[:, None]
    add(dict(name="ring_kv_valid_f32", fn="ring", causal=True, dtype="f32"),
        q=normal(B, T, H, Dh), k=normal(B, T, Hkv, Dh), v=normal(B, T, Hkv, Dh), valid=valid)
    # q.k * scale = -100 on every pair; valid kv only in the last block.
    add(dict(name="ring_negative_f32", fn="ring", causal=True, dtype="f32"),
        q=np.full((B, T, H, Dh), 5.0, np.float32), k=np.full((B, T, Hkv, Dh), -5.0, np.float32),
        v=normal(B, T, Hkv, Dh), valid=np.arange(T)[None, :] >= np.array([28, 30])[:, None])
    S = 64
    mask = np.stack([np.ones(S, bool), np.arange(S) < 6,
                     (np.arange(S) % 3 == 0) & (np.arange(S) < 40)])
    for dt in ("f32", "bf16"):
        add(dict(name=f"decode_{dt}", fn="decode", dtype=dt),
            q=normal(3, H, Dh), k=normal(3, S, Hkv, Dh), v=normal(3, S, Hkv, Dh), mask=mask)
    add(dict(name="decode_negative_f32", fn="decode", dtype="f32"),
        q=np.full((2, H, Dh), 5.0, np.float32), k=np.full((2, S, Hkv, Dh), -5.0, np.float32),
        v=normal(2, S, Hkv, Dh), mask=np.arange(S)[None, :] >= np.array([56, 62])[:, None])
    add(dict(name="decode_int8_f32", fn="decode", dtype="f32", int8=True),
        q=normal(2, H, Dh), k=normal(2, 32, Hkv, Dh), v=normal(2, 32, Hkv, Dh),
        mask=np.arange(32)[None, :] < np.array([32, 11])[:, None])
    K, prior = 4, [10, 3]
    cmask = np.zeros((2, K, 32), bool)
    for b in range(2):
        for j in range(K):
            cmask[b, j, :prior[b] + j + 1] = True
    for dt in ("f32", "bf16"):
        add(dict(name=f"chunk_{dt}", fn="chunk", dtype=dt),
            q=normal(2, K, H, Dh), k=normal(2, 32, Hkv, Dh), v=normal(2, 32, Hkv, Dh),
            mask=cmask)
    add(dict(name="indivisible", fn="indivisible", dtype="f32"), x=np.zeros((1, 13, 2)))
    return cases


def _jax_out(spec, a, mesh):
    dt = jnp.bfloat16 if spec["dtype"] == "bf16" else jnp.float32
    if spec["fn"] == "ring":
        out = jra.ring_attention(*(jnp.asarray(a[n], dt) for n in ("q", "k", "v")), mesh,
                                 causal=spec["causal"],
                                 kv_valid=jnp.asarray(a["valid"]) if "valid" in a else None)
    elif spec.get("int8"):
        kq8, ks = j_quantize_kv(jnp.asarray(a["k"]).transpose(0, 2, 1, 3))
        vq8, vs = j_quantize_kv(jnp.asarray(a["v"]).transpose(0, 2, 1, 3))
        out = jra.sp_decode_attention(jnp.asarray(a["q"]), kq8, vq8, jnp.asarray(a["mask"]),
                                      mesh, k_scale=ks, v_scale=vs)
    else:
        fn = jra.sp_decode_attention if spec["fn"] == "decode" else jra.sp_chunk_decode_attention
        out = fn(*(jnp.asarray(a[n], dt) for n in ("q", "k", "v")), jnp.asarray(a["mask"]),
                 mesh)
    return np.asarray(out, dtype=np.float32)


def _assemble(spec, ranks, tp, sp):
    """The ranks' output shards put back together: ring outputs by
    sequence block (and head block), decode outputs by head block (every
    sp rank holds all positions)."""
    by = {tuple(r["coords"]): r[spec["name"]] for r in ranks}
    head_dim = {"ring": 2, "decode": 1, "chunk": 2}[spec["fn"]]
    rows = []
    for t in range(tp):
        if spec["fn"] == "ring":
            rows.append(np.concatenate([by[(t, s)] for s in range(sp)], axis=1))
        else:
            for s in range(1, sp):
                np.testing.assert_array_equal(by[(t, s)], by[(t, 0)])
            rows.append(by[(t, 0)])
    return np.concatenate(rows, axis=head_dim)


# The composed world runs the f32 cases of each function.
COMPOSED = ("ring_causal_f32", "ring_kv_valid_f32", "decode_f32", "decode_int8_f32", "chunk_f32",
            "indivisible")


def _run_world(tmp, tp, sp):
    cases = [c for c in _cases() if tp == 1 or c[0]["name"] in COMPOSED]
    inputs = os.path.join(tmp, "inputs")
    np.savez(inputs + ".npz", **{f"{s['name']}/{k}": v for s, arrays in cases
                                 for k, v in arrays.items()})
    with open(inputs + ".json", "w") as f:
        json.dump([s for s, _ in cases], f)
    out = os.path.join(tmp, f"out_{tp}x{sp}")
    os.makedirs(out)
    spawn_world("_torch_parallel_worker:ring_cases", tp * sp, timeout_s=WORLD_LIMIT_S,
                args=dict(inputs=inputs, out=out, tp=tp, sp=sp), sys_path=[TESTS], device_type="cpu")
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(tp * sp)]
    return cases, ranks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("ring"))
    return {(tp, sp): _run_world(tmp, tp, sp) for tp, sp in ((1, 2), (2, 2))}


NAMES = [s["name"] for s, _ in _cases()]


@pytest.mark.parametrize("tp,sp,name", [(1, 2, n) for n in NAMES]
                         + [(2, 2, n) for n in COMPOSED])
def test_matches_jax(worlds, name, tp, sp):
    cases, ranks = worlds[(tp, sp)]
    spec, arrays = next(c for c in cases if c[0]["name"] == name)
    if spec["fn"] == "indivisible":
        # A length that does not divide sp raises on every rank, as the
        # JAX functions raise for it.
        assert all(int(r[name]) == 1 for r in ranks)
        with pytest.raises(ValueError, match="divisible"):
            jra.ring_attention(*(jnp.zeros((1, 13, 2, 8)),) * 3, j_build_mesh(1, tp, sp))
        return
    got = _assemble(spec, ranks, tp, sp)
    want = _jax_out(spec, arrays, j_build_mesh(dp=1, tp=tp, sp=sp))
    tol = TOL[spec["dtype"]]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if "negative" in name:
        assert np.abs(got).max() > 0.1  # no underflow to 0 over the empty shards
