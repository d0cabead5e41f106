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
cache layout or a flat directory of ``*.safetensors``).  The JAX
module's born-sharded random init and its boot-peak report are mesh
code and wait for the mesh port (ROADMAP A13); a ``bcg-tpu/*`` preset's
random weights come from :func:`bcg_tpu_torch.models.convert.init_params`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

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


def load_checkpoint_params(
    spec: ModelSpec,
    model_name: str,
    device="cuda",
    leaf_transform=None,
    ckpt_dir: Optional[str] = None,
    dtype=torch.bfloat16,
) -> Dict:
    """Load every ``param_plan`` leaf of ``spec`` onto ``device``.

    ``leaf_transform(logical_name, tensor) -> leaf`` is applied to each
    leaf right after it is placed — e.g. streamed quantization
    (``models/quantize.quantize_leaf_transform``), which keeps peak
    device memory at the final model size instead of bf16 + quantized
    copies.  ``ckpt_dir``: a pre-resolved checkpoint directory (skips the
    candidate walk a caller already did via :func:`find_checkpoint_dir`).
    A checkpoint without ``lm_head.weight`` loads without the head (the
    JAX loader's rule).
    """
    from bcg_tpu_torch.models.convert import dense_leaf
    from bcg_tpu_torch.models.safetensors_np import SafetensorsFile
    from bcg_tpu_torch.models.transformer import param_plan

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
            t = open_files[path].tensor(name, device)
            if logical.split(".")[-1] in _TRANSPOSED:
                t = t.t()
            t = dense_leaf(logical, t, shape, device, dtype)
            params[logical] = leaf_transform(logical, t) if leaf_transform else t
            del t
    finally:
        for handle in open_files.values():
            handle.close()
        open_files.clear()
    return params
