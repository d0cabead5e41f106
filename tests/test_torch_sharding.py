"""``bcg_tpu_torch.parallel.sharding`` and the sharded boot of
``models/loader.py`` against the JAX package, with no world: a rank's
place on the mesh is all the port's slicing reads, so a stand-in mesh
object names it.

* Each rank's slice of every leaf equals the JAX ``shard_params``
  shard on the device at that rank's mesh coordinate, leaf by leaf, at
  tp 2 and 4 on both tiny presets — the head guards (tiny-dh128's one kv
  head, tiny-test's two at tp 4) and int8 / int4 leaves included.
* The byte accounting equals ``kv_cache_bytes_per_device`` (bf16 and
  int8 caches, axes that divide and axes that do not) and
  ``tree_bytes_per_device``; the boot report's final bytes equal the JAX
  report's.
* ``init_random_params_sharded`` equals slices of ``init_params`` for one
  generator and seed (quantized by the sharded quantizer: slices of the
  one-device quantized tree), and a checkpoint read under a mesh equals
  slices of the whole read.  A row-parallel int4 weight is held as the
  contiguous slice of its unpacked rows, where XLA splits the packed rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.models import quantize as jq
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.models.loader import boot_peak_report as j_boot_peak_report
from bcg_tpu.parallel import sharding as js
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu_torch.models import loader
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import init_params, params_from_numpy
from bcg_tpu_torch.models.safetensors_np import save_file
from bcg_tpu_torch.parallel import sharding
import _torch_jax_obs_state

MODELS = ("bcg-tpu/tiny-test", "bcg-tpu/tiny-dh128")


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


class StandInMesh:
    """What the port's slicing reads of a DeviceMesh: the axis names and
    sizes, and this rank's coordinate on each axis."""

    def __init__(self, dp=1, tp=1, sp=1, rank=(0, 0, 0)):
        self.mesh_dim_names = ("dp", "tp", "sp")
        self.mesh = np.zeros((dp, tp, sp))
        self._rank = dict(zip(self.mesh_dim_names, rank))

    def get_local_rank(self, axis):
        return self._rank[axis]

    def size(self):
        return self.mesh.size


def _flat(tree, prefix=""):
    """A JAX param tree as ``(logical name, array)`` pairs, quantized
    parts as ``name.q`` / ``name.scale`` / ``name.q4`` / ``name.gscale``."""
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flat(v, name + ".")
        elif isinstance(v, list):
            for i, layer in enumerate(v):
                out += _flat(layer, f"{name}.{i}.")
        else:
            out.append((name, v))
    return out


def _port_leaf(params, name):
    base, _, part = name.rpartition(".")
    if part in ("q", "scale", "q4", "gscale") and isinstance(params.get(base), dict):
        return params[base][part]
    return params[name]


def _jax_tree(model, quant):
    jp = jt.init_params(j_spec(model), jax.random.PRNGKey(1), dtype=jnp.float32)
    if quant:
        jp = jq.quantize_params(jp, j_spec(model), mode=quant)
    return jp


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_rank_slices_equal_jax_shards(model, tp, quant):
    jp = _jax_tree(model, quant)
    jmesh = j_build_mesh(dp=1, tp=tp, sp=1)
    sharded = js.shard_params(jp, j_spec(model), jmesh)
    spec = spec_for_model(model)
    full = params_from_numpy([(n, np.asarray(a)) for n, a in _flat(jp)], spec, "cpu",
                             torch.float32)
    split = 0
    for r in range(tp):
        device = jmesh.devices[0, r, 0]
        mine = sharding.shard_params(full, spec, StandInMesh(tp=tp, rank=(0, r, 0)))
        for name, arr in _flat(sharded):
            got = _port_leaf(mine, name)
            base, _, part = name.rpartition(".")
            if part in ("q4", "gscale") and sharding.leaf_dim(f"{base}.q4", spec, tp) == 0:
                # A row-parallel int4 weight: the port holds the contiguous
                # slice of the unpacked input rows (repacked locally) where
                # XLA splits the packed rows — the same global leaf.
                _assert_int4_row_slice(mine[base], np.asarray(jp_leaf(jp, base, "q4")),
                                       np.asarray(jp_leaf(jp, base, "gscale")), tp, r, name)
                split += 1
                continue
            shard = next(s for s in arr.addressable_shards if s.device == device)
            want = np.asarray(shard.data)
            if got.dtype == torch.bfloat16:
                got, want = got.float(), want.astype(np.float32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
            split += tuple(got.shape) != tuple(arr.shape)
    assert split > 0


def jp_leaf(tree, base, part):
    """A part of a quantized leaf of a JAX param tree by logical name."""
    return dict(_flat(tree))[f"{base}.{part}"]


def _assert_int4_row_slice(local, q4, gscale, tp, r, name):
    """``local`` (a rank's ``{"q4", "gscale"}``) unpacks to rows ``[r K/tp,
    (r+1) K/tp)`` of the global packed weight ``q4`` ``[K/2, N]``, each
    local row reading its global row's scale."""
    from bcg_tpu_torch.ops.w4_matmul import unpack_int4

    rows = unpack_int4(torch.from_numpy(q4)).numpy()
    K = rows.shape[0]
    n = K // tp
    np.testing.assert_array_equal(unpack_int4(local["q4"]).numpy(), rows[r * n:(r + 1) * n],
                                  err_msg=name)
    per_row = np.repeat(gscale.astype(np.float32), K // gscale.shape[0], axis=0)
    got = local["gscale"].float().numpy()
    got = np.repeat(got, n // got.shape[0], axis=0)
    np.testing.assert_array_equal(got, per_row[r * n:(r + 1) * n], err_msg=name)


@pytest.mark.parametrize("model,tp,heads", [
    ("bcg-tpu/tiny-test", 2, (2, 1)), ("bcg-tpu/tiny-test", 4, (1, 2)),
    ("bcg-tpu/tiny-dh128", 2, (1, 1)), ("bcg-tpu/tiny-dh128", 4, (2, 1)),
])
def test_head_guards_and_local_heads(model, tp, heads):
    """q heads that do not divide tp replicate wq/wo; kv heads that do not
    replicate wk/wv; the local counts and the kv heads each rank's q heads
    read follow."""
    spec = spec_for_model(model)
    assert sharding.local_heads(spec, tp) == heads
    assert (sharding.leaf_dim("layers.0.wq", spec, tp) is None) == (spec.num_heads % tp != 0)
    assert (sharding.leaf_dim("layers.0.wk", spec, tp) is None) == (spec.num_kv_heads % tp != 0)
    assert sharding.leaf_dim("layers.0.wo.scale", spec, tp) is None
    # A row-parallel int4 weight's scales follow its own rows' groups.
    assert sharding.leaf_dim("layers.0.w_down.gscale", spec, tp) == 0
    assert sharding.leaf_dim("layers.0.w_up.gscale", spec, tp) == 1
    g = spec.num_heads // spec.num_kv_heads
    for r in range(tp):
        par = sharding.ModelParallel(spec, StandInMesh(tp=tp, rank=(0, r, 0)))
        q_heads = range(r * heads[0], (r + 1) * heads[0]) if par.heads_split \
            else range(spec.num_heads)
        kv = torch.arange(spec.num_kv_heads)[None, None, :, None]
        read = par.select_kv(kv)[0, 0, :, 0].tolist()
        want = sorted({h // g for h in q_heads})
        if par.heads_split and not par.kv_split:
            assert read == want
        elif par.kv_split:
            assert read == list(range(spec.num_kv_heads))  # already this rank's own


CACHE_CASES = [((2, 2, 2), 4, 64), ((2, 2, 2), 3, 63), ((1, 4, 2), 2, 96), ((4, 1, 2), 8, 16),
               ((1, 8, 1), 2, 32)]


@pytest.mark.parametrize("quantized", [False, "int8"])
@pytest.mark.parametrize("mesh_shape,B,S", CACHE_CASES)
@pytest.mark.parametrize("model", MODELS)
def test_kv_cache_bytes_per_device_equal_jax(model, mesh_shape, B, S, quantized):
    dp, tp, sp = mesh_shape
    jmesh = j_build_mesh(dp=dp, tp=tp, sp=sp)
    shapes = jax.eval_shape(lambda: jt.init_kv_cache(j_spec(model), B, S,
                                                     quantized=bool(quantized)))
    want = js.kv_cache_bytes_per_device(jmesh, shapes, quantized=bool(quantized))
    leaves = [(tuple(x.shape), np.dtype(x.dtype)) for x in jax.tree.leaves(shapes)]
    got = sharding.kv_cache_bytes_per_device(StandInMesh(dp, tp, sp), leaves,
                                             quantized=bool(quantized))
    assert got == want


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_tree_bytes_and_boot_report_equal_jax(model, tp):
    jmesh = j_build_mesh(dp=1, tp=tp, sp=1)
    jp = jt.init_params(j_spec(model), jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    want = js.tree_bytes_per_device(js.shard_params(jp, j_spec(model), jmesh))
    spec = spec_for_model(model)
    full = params_from_numpy([(n, np.asarray(a)) for n, a in _flat(jp)], spec, "cpu")
    mine = sharding.shard_params(full, spec, StandInMesh(tp=tp, rank=(0, 1, 0)))
    assert sharding.tree_bytes_per_device(mine) == want
    report = loader.boot_peak_report(spec, StandInMesh(tp=tp))
    j_report = j_boot_peak_report(j_spec(model), jmesh, scan_layers=False)
    assert report["final_bytes_per_device"] == j_report["final_bytes_per_device"] == want
    # The port draws each leaf whole: its peak holds one full leaf's f32
    # draw and bf16 copy beside the shards so far.
    assert report["init_peak_bytes_per_device"] > report["final_bytes_per_device"]
    assert report["max_init_transient_leaf"] in ("embed", "lm_head")


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_sharded_init_equals_slices_of_init_params(model, tp):
    spec = spec_for_model(model)
    g = torch.Generator().manual_seed(7)
    full = init_params(spec, g, "cpu")
    for r in range(tp):
        mesh = StandInMesh(tp=tp, rank=(0, r, 0))
        got = loader.init_random_params_sharded(spec, torch.Generator().manual_seed(7), mesh,
                                                "cpu")
        want = sharding.shard_params(full, spec, mesh)
        assert set(got) == set(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
            assert got[name].is_contiguous()


def test_sharded_init_refuses_quantization_and_checkpoint_reads_slices(tmp_path):
    """A leaf transform that does not shard is refused under tp (it would
    quantize a slice); the sharded quantizer's transform loads each rank's
    slices of the one-device quantized tree, drawn or read."""
    from bcg_tpu_torch.models.quantize import quantize_leaf_transform, quantize_params

    spec = spec_for_model("bcg-tpu/tiny-test")
    with pytest.raises(ValueError, match="must take full leaves"):
        loader.init_random_params_sharded(spec, torch.Generator(), StandInMesh(tp=2), "cpu",
                                          leaf_transform=lambda n, t: t)
    one = quantize_params(init_params(spec, torch.Generator().manual_seed(3), "cpu"), spec,
                          mode="int8")
    for r in range(2):
        mesh = StandInMesh(tp=2, rank=(0, r, 0))
        got = loader.init_random_params_sharded(
            spec, torch.Generator().manual_seed(3), mesh, "cpu",
            leaf_transform=quantize_leaf_transform(spec, "int8", mesh=mesh))
        want = sharding.shard_params(one, spec, mesh)
        assert set(got) == set(want)
        for name, leaf in want.items():
            for part, t in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
                g = got[name][part] if part else got[name]
                assert torch.equal(g, t), (name, part)
    full = init_params(spec, torch.Generator().manual_seed(3), "cpu")
    tensors = {}
    for name, t in full.items():
        if name.split(".")[-1] in loader._TRANSPOSED:
            t = t.t().contiguous()
        tensors[loader.hf_name(name)] = t
    save_file(tensors, str(tmp_path / "model.safetensors"))
    whole = loader.load_checkpoint_params(spec, "tiny", "cpu", ckpt_dir=str(tmp_path))
    for r in range(2):
        mesh = StandInMesh(tp=2, rank=(0, r, 0))
        got = loader.load_checkpoint_params(spec, "tiny", "cpu", ckpt_dir=str(tmp_path),
                                            mesh=mesh)
        want = sharding.shard_params(whole, spec, mesh)
        for name in want:
            assert torch.equal(got[name], want[name]), name


@pytest.mark.parametrize("quantized", [False, "int8", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", MODELS)
def test_paged_pool_local_shapes_equal_jax_shards(model, tp, quantized):
    """A paged pool splits kv heads over tp only (every rank reads any
    block), where they divide: each leaf's local shape is the JAX shard's."""
    from bcg_tpu.ops.paged_attention import init_block_pool

    jmesh = j_build_mesh(dp=2, tp=tp, sp=1) if tp == 2 else j_build_mesh(dp=1, tp=tp, sp=2)
    pool = jax.eval_shape(lambda: init_block_pool(j_spec(model), 8, 16, quantized=quantized))
    shardings = js.paged_pool_tree_sharding(jmesh, pool, quantized=bool(quantized))
    mesh = StandInMesh(*jmesh.devices.shape)
    for leaf, sh in zip(jax.tree.leaves(pool), jax.tree.leaves(
            shardings, is_leaf=lambda s: isinstance(s, jax.sharding.NamedSharding))):
        axes = sharding.paged_pool_layout(bool(quantized), leaf.ndim)
        assert sharding.local_shape(mesh, axes, leaf.shape) == sh.shard_shape(leaf.shape)
