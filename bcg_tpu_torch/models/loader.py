"""HF checkpoint loading: safetensors -> the port's parameter dict — the
port of ``bcg_tpu/models/loader.py``.

Weights stream tensor by tensor from the safetensors shards
(:mod:`bcg_tpu_torch.models.safetensors_np`, through ``np.memmap``: the
host never holds a shard whole) onto the device, each leaf converted
there as :func:`~bcg_tpu_torch.models.convert.dense_leaf` converts one
(HF ``[out, in]`` projections transposed to ``[in, out]``, cast,
contiguous), then passed through ``leaf_transform``: with
``quantize.quantize_leaf_transform`` the bf16 model never exists whole
on the card.  The names, the transposes and the tied-embedding,
``qk_norm`` and ``attn_bias`` rules are the JAX loader's.

There is no network, so checkpoints must exist on local disk (the HF
cache layout or a flat directory of ``*.safetensors``).  Under a mesh a
load reads only the rank's slice of each tensor out of the mapping (the
whole tensor where the sharded quantizer must see it whole).

A ``bcg-tpu/*`` preset's random weights come from
:func:`bcg_tpu_torch.models.convert.init_params`, or under a mesh from
:func:`init_random_params_sharded` (the same values, the rank's slices);
:func:`boot_peak_report` accounts that boot's device memory without
making a weight.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch

from bcg_tpu_torch.models.configs import ModelSpec
from bcg_tpu_torch.runtime.envflags import get_str

# HF parameter name templates for the Qwen/Llama/Mistral family.
_LAYER_MAP = {
    "attn_norm": "model.layers.{i}.input_layernorm.weight",
    "wq": "model.layers.{i}.self_attn.q_proj.weight",
    "wk": "model.layers.{i}.self_attn.k_proj.weight",
    "wv": "model.layers.{i}.self_attn.v_proj.weight",
    "bq": "model.layers.{i}.self_attn.q_proj.bias",
    "bk": "model.layers.{i}.self_attn.k_proj.bias",
    "bv": "model.layers.{i}.self_attn.v_proj.bias",
    "wo": "model.layers.{i}.self_attn.o_proj.weight",
    "q_norm": "model.layers.{i}.self_attn.q_norm.weight",
    "k_norm": "model.layers.{i}.self_attn.k_norm.weight",
    "mlp_norm": "model.layers.{i}.post_attention_layernorm.weight",
    "w_gate": "model.layers.{i}.mlp.gate_proj.weight",
    "w_up": "model.layers.{i}.mlp.up_proj.weight",
    "w_down": "model.layers.{i}.mlp.down_proj.weight",
}
_TOP_MAP = {
    "embed": "model.embed_tokens.weight",
    "final_norm": "model.norm.weight",
    "lm_head": "lm_head.weight",
}
# HF stores projections as [out, in]; our layout is [in, out].
_TRANSPOSED = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}


def find_checkpoint_dir(model_name: str) -> Optional[str]:
    """Locate a local checkpoint: explicit dir, HF cache, or env override."""
    candidates = []
    env = get_str("BCG_TPU_CHECKPOINT_DIR")
    if env:
        candidates.append(os.path.join(env, model_name.replace("/", "--")))
        candidates.append(env)
    candidates.append(model_name)  # model_name may itself be a path
    # Repo-local checkpoints (e.g. the hermetic bcg-hf/* artifact sets
    # built by models/hf_fixture.py).
    candidates.append(os.path.join("checkpoints", model_name.replace("/", "--")))
    hf_home = os.environ.get("HF_HOME", os.path.expanduser("~/.cache/huggingface"))
    snap_root = os.path.join(
        hf_home, "hub", f"models--{model_name.replace('/', '--')}", "snapshots"
    )
    if os.path.isdir(snap_root):
        for snap in sorted(os.listdir(snap_root)):
            candidates.append(os.path.join(snap_root, snap))
    for c in candidates:
        if c and os.path.isdir(c) and any(
            f.endswith(".safetensors") for f in os.listdir(c)
        ):
            return c
    return None


def require_checkpoint_dir(model_name: str) -> str:
    """:func:`find_checkpoint_dir`, raising ``FileNotFoundError`` when
    there is no local checkpoint."""
    ckpt_dir = find_checkpoint_dir(model_name)
    if ckpt_dir is None:
        raise FileNotFoundError(
            f"No local safetensors checkpoint found for {model_name!r} "
            "(zero-egress environment: download is not possible; set "
            "BCG_TPU_CHECKPOINT_DIR or use a bcg-tpu/* random-weight preset)"
        )
    return ckpt_dir


def hf_name(logical: str) -> str:
    """The HF tensor name of a ``param_plan`` logical name."""
    parts = logical.split(".")
    if parts[0] == "layers":
        return _LAYER_MAP[parts[2]].format(i=int(parts[1]))
    return _TOP_MAP[logical]


def _full_leaves(mesh, leaf_transform) -> bool:
    """Whether a load under ``mesh`` hands ``leaf_transform`` each FULL
    leaf (a sharding transform: the sharded quantizer) rather than the
    rank's slice.  A transform that does not shard cannot run under a
    ``tp`` split: quantizing a slice would not give the slice of the
    quantized leaf."""
    from bcg_tpu_torch.parallel.mesh import mesh_shape

    if leaf_transform is None or mesh_shape(mesh)["tp"] == 1:
        return False
    if not getattr(leaf_transform, "shards", False):
        raise ValueError("a leaf transform under a tp mesh must take full leaves and "
                         "shard them (models.quantize.quantize_leaf_transform(..., mesh=))")
    return True


def init_random_params_sharded(spec: ModelSpec, generator: torch.Generator, mesh=None,
                               device="cuda", dtype=torch.bfloat16,
                               leaf_transform=None) -> Dict:
    """:func:`~bcg_tpu_torch.models.convert.init_params`'s weights, this
    rank's slices only (``parallel.sharding.shard_leaf``; a sharding
    ``leaf_transform``, the sharded quantizer, takes each full leaf and
    slices it itself).  The leaves are
    drawn one after another from one generator, so each full leaf is drawn
    on the device (the same values, leaf for leaf, as ``init_params`` for
    the same generator and seed), its slice kept and the rest freed: peak
    device memory is the shards so far plus one full leaf (its f32 draw
    and its ``dtype`` copy).  ``mesh=None`` is ``init_params``."""
    from bcg_tpu_torch.models.convert import init_params
    from bcg_tpu_torch.models.transformer import param_plan
    from bcg_tpu_torch.parallel.sharding import shard_leaf

    if mesh is None:
        return init_params(spec, generator, device, dtype, leaf_transform)
    full_leaves = _full_leaves(mesh, leaf_transform)
    params = {}
    for name, kind, shape in param_plan(spec):
        if kind == "dense":
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            w.mul_(1.0 / math.sqrt(shape[0]))
            leaf = w.to(dtype)
            del w
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            leaf = fill(shape, dtype=dtype, device=device)
        if full_leaves:
            params[name] = leaf_transform(name, leaf)
        else:
            leaf = shard_leaf(name, leaf, spec, mesh, shape)
            params[name] = (leaf_transform(name, leaf) if leaf_transform and kind == "dense"
                            else leaf)
        del leaf
    return params


def boot_peak_report(spec: ModelSpec, mesh=None, quantization: Optional[str] = None,
                     dtype=torch.bfloat16) -> Dict:
    """Per-device boot memory of :func:`init_random_params_sharded`,
    worked out from the plan's shapes (no weight is made): the final tree
    (each leaf at its shard's size), and the init peak — the tree so far
    plus the current leaf's transient, which in the port is the FULL leaf
    (its f32 draw beside its ``dtype`` copy; the JAX package draws shards
    directly).  The port keeps no stacked layout, so there is no
    stacking phase."""
    from bcg_tpu_torch.models.convert import _quantized_shapes
    from bcg_tpu_torch.models.quantize import is_quant_leaf
    from bcg_tpu_torch.models.transformer import param_plan
    from bcg_tpu_torch.parallel.mesh import mesh_shape
    from bcg_tpu_torch.parallel.sharding import leaf_dim

    tp = mesh_shape(mesh)["tp"]
    itemsize = torch.empty((), dtype=dtype).element_size()
    parts_bytes = {"q": 1, "scale": 4, "q4": 1, "gscale": 2}

    def shard(name, shape, nbytes_each):
        dim = leaf_dim(name, spec, tp)
        n = int(np.prod(shape, dtype=np.int64))
        return n * nbytes_each // (tp if dim is not None else 1)

    done = init_peak = max_transient = 0
    max_leaf = None
    for name, kind, shape in param_plan(spec):
        full = int(np.prod(shape, dtype=np.int64))
        # The quantizer takes the blocks' dense weights and the LM head;
        # the embedding stays bf16 (``quantize.is_quant_leaf``).
        quantized = kind == "dense" and quantization is not None and is_quant_leaf(name)
        if quantized:
            parts = ("q", "scale") if quantization == "int8" else ("q4", "gscale")
            out_b = sum(shard(f"{name}.{p}", shp, parts_bytes[p])
                        for p, shp in _quantized_shapes(parts, shape).items())
        else:
            out_b = shard(name, shape, itemsize)
        transient = full * (4 + itemsize) if kind == "dense" else full * itemsize
        if quantized and tp > 1:
            # The sharded quantizer quantizes the whole leaf before slicing it.
            transient += sum(int(np.prod(shp, dtype=np.int64)) * parts_bytes[p]
                             for p, shp in _quantized_shapes(parts, shape).items())
        init_peak = max(init_peak, done + transient + out_b)
        if transient > max_transient:
            max_transient, max_leaf = transient, name
        done += out_b
    return {
        "final_bytes_per_device": done,
        "init_peak_bytes_per_device": init_peak,
        "peak_bytes_per_device": init_peak,
        "max_init_transient_bytes": max_transient,
        "max_init_transient_leaf": max_leaf,
        "devices": 1 if mesh is None else mesh.size(),
        "quantization": quantization,
    }


def _read_slice(handle, name: str, transposed: bool, dim: Optional[int], tp: int, r: int,
                device) -> torch.Tensor:
    """Rank ``r``'s slice of a checkpoint tensor along logical ``dim``
    (the HF dim is ``1 - dim`` for a transposed ``[out, in]`` tensor),
    read out of the file's mapping: only the slice is copied."""
    if dim is None:
        return handle.tensor(name, device)
    arr = handle.numpy(name)
    hf_dim = (1 - dim) if transposed else dim
    n = arr.shape[hf_dim] // tp
    idx = [slice(None)] * arr.ndim
    idx[hf_dim] = slice(r * n, (r + 1) * n)
    part = np.ascontiguousarray(arr[tuple(idx)])
    tag = handle.dtype(name)
    t = (torch.from_numpy(part.view(np.int16)).view(torch.bfloat16) if tag == "BF16"
         else torch.from_numpy(part))
    return t.to(device)


def load_checkpoint_params(
    spec: ModelSpec,
    model_name: str,
    device="cuda",
    leaf_transform=None,
    ckpt_dir: Optional[str] = None,
    dtype=torch.bfloat16,
    mesh=None,
) -> Dict:
    """Load every ``param_plan`` leaf of ``spec`` onto ``device``.

    ``leaf_transform(logical_name, tensor) -> leaf`` is applied to each
    leaf right after it is placed — e.g. streamed quantization
    (``models/quantize.quantize_leaf_transform``), which keeps peak
    device memory at the final model size instead of bf16 + quantized
    copies.  ``ckpt_dir``: a pre-resolved checkpoint directory (skips the
    candidate walk a caller already did via :func:`find_checkpoint_dir`).
    A checkpoint without ``lm_head.weight`` loads without the head (the
    JAX loader's rule).  Under a ``mesh`` each leaf is this rank's
    ``tp`` slice (``parallel.sharding``), read out of the file's mapping
    without the rest of the tensor — or, for a sharding ``leaf_transform``
    (the sharded quantizer), read whole and handed to it.
    """
    from bcg_tpu_torch.models.convert import dense_leaf
    from bcg_tpu_torch.models.safetensors_np import SafetensorsFile
    from bcg_tpu_torch.models.transformer import param_plan
    from bcg_tpu_torch.parallel.mesh import mesh_shape
    from bcg_tpu_torch.parallel.sharding import leaf_dim

    full_leaves = _full_leaves(mesh, leaf_transform)
    tp = mesh_shape(mesh)["tp"]
    r = mesh.get_local_rank("tp") if tp > 1 else 0

    if ckpt_dir is None:
        ckpt_dir = require_checkpoint_dir(model_name)
    shard_files = sorted(
        os.path.join(ckpt_dir, f)
        for f in os.listdir(ckpt_dir)
        if f.endswith(".safetensors")
    )
    # Index every tensor name to its shard (headers only).
    name_to_file: Dict[str, str] = {}
    for path in shard_files:
        with SafetensorsFile(path) as f:
            for name in f.keys():
                name_to_file[name] = path

    open_files: Dict[str, SafetensorsFile] = {}
    params: Dict = {}
    try:
        for logical, _kind, shape in param_plan(spec):
            name = hf_name(logical)
            if name not in name_to_file:
                if logical == "lm_head":
                    continue  # tied embeddings checkpoint
                raise KeyError(f"{name} missing from checkpoint {ckpt_dir}")
            path = name_to_file[name]
            if path not in open_files:
                open_files[path] = SafetensorsFile(path)
            transposed = logical.split(".")[-1] in _TRANSPOSED
            # A sharding transform takes the full leaf (quantized whole,
            # then sliced); otherwise only the rank's slice is read.
            dim = None if full_leaves else leaf_dim(logical, spec, tp)
            t = _read_slice(open_files[path], name, transposed, dim, tp, r, device)
            if transposed:
                t = t.t()
            if dim is not None:
                shape = tuple(d // tp if i == dim else d for i, d in enumerate(shape))
            t = dense_leaf(logical, t, shape, device, dtype)
            params[logical] = leaf_transform(logical, t) if leaf_transform else t
            del t
    finally:
        for handle in open_files.values():
            handle.close()
        open_files.clear()
    return params
