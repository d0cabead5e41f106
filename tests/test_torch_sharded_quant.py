"""The sharded quantizer (ROADMAP A13b item 1): int8 and int4 weights under
tp, against the one-device quantized tree and the JAX package's
``_sharded_quantizer``.

The JAX package quantizes under GSPMD, whose semantics are global: each
device's leaves are slices of the one-device quantized tree.  So are the
port's — each full leaf is quantized whole, then sliced
(``models/quantize.quantize_leaf_transform(mesh=)``,
``parallel/sharding.shard_leaf``):

* int8: a row-parallel parent's per-output-channel scale is the absmax
  over ALL its input rows (replicated); every part is bit-equal to the
  slice of the one-device tree.
* int4: a row-parallel parent (``wo``, ``w_down``) holds the contiguous
  slice of its unpacked input rows, repacked locally (rows ``i`` and ``i +
  K_local/2`` in one byte), with the scales of its own rows' groups — not
  XLA's split of the packed rows, which would hand a rank global rows
  ``i`` and ``i + K/2`` while its activations hold a contiguous slice.
  Column-parallel parents and the vocabulary-split head slice their
  output columns.

A rank's place on the mesh is all the slicing reads, so a stand-in mesh
names it (as ``tests/test_torch_sharding.py`` does); the row-parallel
product (W8A8 with the whole row's activation scale and an exact int32
sum over tp) runs in a gloo world of 2 ranks.  B5's wrapper takes the
sharded int4 leaves at bench-8b's local shapes (its checks, on meta
tensors: no bench-8b weight is made).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.models import quantize as jq
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu_torch.models import artifact, loader
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import init_params, params_from_numpy
from bcg_tpu_torch.models.quantize import (
    dequantize_int4, quantize_leaf_transform, quantize_params, weight_quantizer)
from bcg_tpu_torch.models.safetensors_np import save_file
from bcg_tpu_torch.ops import w4_matmul
from bcg_tpu_torch.parallel import sharding
from bcg_tpu_torch.parallel.distributed import spawn_world
import _torch_jax_obs_state

TESTS = os.path.dirname(os.path.abspath(__file__))
MODELS = ("bcg-tpu/tiny-test", "bcg-tpu/tiny-dh128")
MODES = ("int8", "int4")


class StandInMesh:
    """What the port's slicing reads of a DeviceMesh: the axes' sizes and
    this rank's coordinates."""

    def __init__(self, tp=1, rank=0):
        self.mesh_dim_names = ("dp", "tp", "sp")
        self.mesh = np.zeros((1, tp, 1))
        self._rank = {"dp": 0, "tp": rank, "sp": 0}

    def get_local_rank(self, axis):
        return self._rank[axis]

    def size(self):
        return self.mesh.size


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


def _flat(tree, prefix=""):
    out = []
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out += _flat(v, name + ".")
        elif isinstance(v, list):
            for i, layer in enumerate(v):
                out += _flat(layer, f"{name}.{i}.")
        else:
            out.append((name, np.asarray(v)))
    return out


def _parts(tree):
    """``{name.part: tensor}`` of a flat port tree."""
    return {f"{n}.{p}" if p else n: t for n, leaf in tree.items()
            for p, t in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)])}


def _weight(leaf):
    """A quantized leaf's f32 weight ``[in, out]`` (or a plain leaf)."""
    if not isinstance(leaf, dict):
        return leaf.float()
    if "q4" in leaf:
        return dequantize_int4(leaf).float()
    return leaf["q"].float() * leaf["scale"]


def _assemble(name, slices, spec, tp):
    """The whole weight from the ranks' slices, along the split dim."""
    dim = sharding.leaf_dim(name, spec, tp)
    ws = [_weight(s) for s in slices]
    return ws[0] if dim is None else torch.cat(ws, dim=dim)


@pytest.fixture(scope="module")
def trees():
    """Per model: the f32 weights (the JAX initializer's) and the
    one-device quantized trees."""
    out = {}
    for model in MODELS:
        spec = spec_for_model(model)
        jp = jt.init_params(j_spec(model), jax.random.PRNGKey(1), dtype=jnp.float32)
        full = params_from_numpy(_flat(jp), spec, "cpu", torch.float32)
        out[model] = (jp, full, {m: quantize_params(full, spec, mode=m) for m in MODES})
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", MODELS)
def test_rank_leaves_are_slices_of_the_one_device_tree(trees, model, mode):
    """Through the engine's shared-tree path (``shard_params`` with the
    quantizer) and the sharded init (``init_random_params_sharded`` with
    the sharded transform): int8 parts bit-equal to the slices; int4
    row-parallel weights unpack to the contiguous input rows, each row
    reading its own group's scale."""
    spec = spec_for_model(model)
    _, full, one = trees[model]
    one = one[mode]
    born = quantize_params(init_params(spec, torch.Generator().manual_seed(2), "cpu"), spec,
                           mode=mode)
    split = 0
    for r in range(2):
        mesh = StandInMesh(tp=2, rank=r)
        mine = sharding.shard_params(full, spec, mesh, quantize=weight_quantizer(mode))
        drawn = loader.init_random_params_sharded(
            spec, torch.Generator().manual_seed(2), mesh, "cpu",
            leaf_transform=quantize_leaf_transform(spec, mode, mesh=mesh))
        for got, tree in ((mine, one), (drawn, born)):
            for name, leaf in tree.items():
                if not isinstance(leaf, dict):
                    continue
                local = got[name]
                row_int4 = "q4" in leaf and sharding.leaf_dim(f"{name}.q4", spec, 2) == 0
                if row_int4:
                    from bcg_tpu_torch.ops.w4_matmul import unpack_int4

                    rows = unpack_int4(leaf["q4"])
                    n = rows.shape[0] // 2
                    assert torch.equal(unpack_int4(local["q4"]), rows[r * n:(r + 1) * n]), name
                    w = dequantize_int4(leaf).float()
                    assert torch.equal(dequantize_int4(local).float(), w[r * n:(r + 1) * n]), name
                    assert w4_matmul.is_kernel_layout(local["q4"])
                    split += 1
                    continue
                for part, t in leaf.items():
                    # The slice of each part along its split dim (a
                    # row-parallel int8 scale replicates: its absmax ran
                    # over every input row).
                    dim = sharding.leaf_dim(f"{name}.{part}", spec, 2)
                    n = t.shape[dim] // 2 if dim is not None else None
                    want = t if dim is None else t.narrow(dim, r * n, n)
                    assert torch.equal(local[part], want), (name, part)
                    split += dim is not None
    assert split > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", MODELS)
def test_jax_sharded_quantizer_gathers_to_the_ranks_leaves(trees, model, mode):
    """The JAX ``_sharded_quantizer`` on a tp 2 mesh, gathered: every
    weight equals the ranks' slices reassembled (int8 bit for bit, int4
    in its dequantized values, the packing being another)."""
    spec = spec_for_model(model)
    jp, full, _ = trees[model]
    jmesh = j_build_mesh(dp=1, tp=2, sp=1)
    gathered = dict(_flat(jq.quantize_params(jp, j_spec(model), mode=mode, mesh=jmesh)))
    ranks = [sharding.shard_params(full, spec, StandInMesh(tp=2, rank=r),
                                   quantize=weight_quantizer(mode)) for r in range(2)]
    checked = 0
    for name, leaf in ranks[0].items():
        if not isinstance(leaf, dict):
            continue
        if mode == "int8":
            want = torch.from_numpy(gathered[f"{name}.q"]).float() * torch.from_numpy(
                gathered[f"{name}.scale"])
        else:
            gscale = gathered[f"{name}.gscale"]   # bf16: its bits through int16
            want = dequantize_int4({"q4": torch.from_numpy(gathered[f"{name}.q4"]),
                                    "gscale": torch.from_numpy(gscale.view(np.int16)).view(
                                        torch.bfloat16)}).float()
        got = _assemble(f"{name}.{'q' if mode == 'int8' else 'q4'}",
                        [rk[name] for rk in ranks], spec, 2)
        assert torch.equal(got, want), name
        checked += 1
    assert checked == 7 * spec.num_layers + 1


@pytest.mark.parametrize("mode", MODES)
def test_checkpoint_and_artifact_loads_under_a_mesh_give_the_slices(tmp_path, trees, mode):
    """A streamed HF checkpoint read under tp through the sharded
    quantizer, and a pre-quantized artifact read under tp, give each rank
    the slices of the one-device quantized tree, part for part."""
    model = "bcg-tpu/tiny-test"
    spec = spec_for_model(model)
    _, full, one = trees[model]
    hf = tmp_path / "hf"
    hf.mkdir()
    save_file({loader.hf_name(n): (t.t().contiguous() if n.split(".")[-1] in loader._TRANSPOSED
                                   else t) for n, t in full.items()},
              str(hf / "model.safetensors"))
    art = str(tmp_path / "art")
    artifact.save_quantized_artifact(one[mode], spec, mode, art)
    for r in range(2):
        mesh = StandInMesh(tp=2, rank=r)
        want = _parts(sharding.shard_params(one[mode], spec, mesh))
        streamed = loader.load_checkpoint_params(
            spec, model, "cpu", ckpt_dir=str(hf), dtype=torch.float32, mesh=mesh,
            leaf_transform=quantize_leaf_transform(spec, mode, mesh=mesh))
        loaded = artifact.load_quantized_artifact(spec, art, mode, "cpu", mesh=mesh)
        for got in (_parts(streamed), _parts(loaded)):
            assert set(got) == set(want)
            for name, t in want.items():
                assert torch.equal(got[name], t), name


# bench-8b at tp 2: each quantized weight's full shape, and whether its
# local shape must be the kernel's (the LM head's N 75,968 a rank).
BENCH_SHAPES = {"layers.0.wq": (4096, 4096), "layers.0.wk": (4096, 1024),
                "layers.0.wv": (4096, 1024), "layers.0.w_gate": (4096, 12288),
                "layers.0.w_up": (4096, 12288), "layers.0.wo": (4096, 4096),
                "layers.0.w_down": (12288, 4096), "lm_head": (4096, 151936)}
LOCAL = {"layers.0.wq": (4096, 2048), "layers.0.wk": (4096, 512), "layers.0.wv": (4096, 512),
         "layers.0.w_gate": (4096, 6144), "layers.0.w_up": (4096, 6144),
         "layers.0.wo": (2048, 4096), "layers.0.w_down": (6144, 4096),
         "lm_head": (4096, 75968)}


@pytest.mark.parametrize("name", sorted(BENCH_SHAPES))
def test_b5_wrapper_takes_the_local_int4_leaves_at_bench_8b(name):
    spec = spec_for_model("bcg-tpu/bench-8b")
    w = torch.empty(BENCH_SHAPES[name], device="meta")
    full = weight_quantizer("int4")(w)
    for r in range(2):
        local = sharding.shard_leaf(name, full, spec, StandInMesh(tp=2, rank=r),
                                    BENCH_SHAPES[name])
        K, N = LOCAL[name]
        assert tuple(local["q4"].shape) == (K // 2, N)
        assert tuple(local["gscale"].shape) == (K // 128, N)
        for M in (1, 10, 256):
            x = torch.empty((M, K), dtype=torch.bfloat16, device="meta")
            w4_matmul._check(x, local["q4"], local["gscale"])
            plan = w4_matmul.split_plan(M, K // 2, N, 132)
            assert plan.splits >= 1


def test_row_parallel_products_equal_one_device(tmp_path):
    """W8A8 under tp 2 is one device's product bit for bit (the whole
    row's activation scale, an exact int32 sum); W4A16 sums f32 partials,
    within f32 rounding of it; W8A16 sums its partials' f32 accumulators
    and rounds once to bf16, as one device's product does, within one bf16
    step of it."""
    rng = np.random.default_rng(7)
    inputs = str(tmp_path / "inputs")
    np.savez(inputs + ".npz", x=rng.standard_normal((3, 5, 512)).astype(np.float32),
             w=(rng.standard_normal((512, 256)) / 16).astype(np.float32))
    out = str(tmp_path / "out")
    os.makedirs(out)
    spawn_world("_torch_parallel_worker:row_parallel_cases", 2, timeout_s=120,
                args=dict(inputs=inputs, out=out), sys_path=[TESTS], device_type="cpu")
    for r in range(2):
        res = np.load(os.path.join(out, f"rank{r}.npz"))
        np.testing.assert_array_equal(res["int8_0/mesh"], res["int8_0/one"])
        for key in ("int4_0", "int4_4"):
            np.testing.assert_allclose(res[f"{key}/mesh"], res[f"{key}/one"], rtol=1e-5,
                                       atol=1e-5)
        np.testing.assert_allclose(res["int8_4/mesh"], res["int8_4/one"], rtol=2 ** -8,
                                   atol=1e-6)
