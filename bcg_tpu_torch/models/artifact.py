"""Pre-quantized checkpoint artifacts: quantize once, serve many — the
port of ``bcg_tpu/models/artifact.py``.

An artifact is an already-quantized weight tree (int8 W8A8 or
grouped-int4 W4A16, ``models/quantize.py``) saved as safetensors and
loaded back directly: boot skips both the bf16 shard streaming and the
quantization pass.  The files are the JAX package's format, byte for
byte, so an artifact written by either package loads in the other:

* ``bcg_tpu_quantized.json`` — manifest: format version, quantization
  mode, model/spec fingerprint, and a logical-dtype map (numpy has no
  bf16, so bf16 tensors are stored as their uint16 bit patterns).
* ``top.safetensors`` — embed / final_norm / lm_head leaves.
* ``layer_NNNN.safetensors`` — one file per decoder layer.

Tensors are keyed by logical path ("embed", "layers.3.wq.q", ...) and
stored in the ``[in, out]`` row-major layout.  The port keeps ``q`` and
``q4`` output-major in memory (``quantize.int8_weight_layout`` /
``int4_weight_layout``): the same values in another layout, so a save
writes them row-major and a load lays them out again
(``convert.quantized_leaf``).

Convert a local HF checkpoint from the command line (CPU works)::

    python -m bcg_tpu_torch.models.artifact --model <name-or-dir> \\
        --mode int8 --out /path/to/artifact [--device cpu]

It quantizes on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from bcg_tpu_torch.models.configs import ModelSpec, spec_for_model

MANIFEST = "bcg_tpu_quantized.json"
_FORMAT = "bcg-tpu-quantized-v1"
_TOP = ("embed", "final_norm", "lm_head")


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """Device tensor -> (row-major storage ndarray, logical dtype string):
    bf16 as uint16 bit patterns, everything else as its own numpy dtype."""
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _flatten(prefix: str, leaf, out: Dict[str, np.ndarray], dtypes: Dict[str, str]):
    parts = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
    for k, v in parts:  # quantized {"q","scale"} / {"q4","gscale"}
        name = prefix if k is None else f"{prefix}.{k}"
        out[name], dtypes[name] = _to_numpy(v)


def save_quantized_artifact(params: Dict, spec: ModelSpec, mode: str, out_dir: str) -> None:
    """Write a quantized param dict as a serve-ready artifact.

    ``params`` must be the post-quantization dict the engine serves
    (``quantize_params`` / streamed ``quantize_leaf_transform`` output,
    including the explicit ``lm_head`` for tied-embedding models)."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"artifact mode {mode!r}: expected 'int8' or 'int4'")
    from bcg_tpu_torch.models.safetensors_np import save_file

    os.makedirs(out_dir, exist_ok=True)
    dtypes: Dict[str, str] = {}

    top: Dict[str, np.ndarray] = {}
    for name in _TOP:
        if name in params:
            _flatten(name, params[name], top, dtypes)
    save_file(top, os.path.join(out_dir, "top.safetensors"))

    for i in range(spec.num_layers):
        flat: Dict[str, np.ndarray] = {}
        pre = f"layers.{i}."
        for name, leaf in params.items():
            if name.startswith(pre):
                _flatten(name, leaf, flat, dtypes)
        save_file(flat, os.path.join(out_dir, f"layer_{i:04d}.safetensors"))

    manifest = {
        "format": _FORMAT,
        "mode": mode,
        "model": spec.name,
        "num_layers": spec.num_layers,
        "hidden_size": spec.hidden_size,
        "vocab_size": spec.vocab_size,
        "num_heads": spec.num_heads,
        "num_kv_heads": spec.num_kv_heads,
        "head_dim": spec.head_dim,
        "intermediate_size": spec.intermediate_size,
        "dtypes": dtypes,
    }
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def artifact_mode(ckpt_dir: Optional[str]) -> Optional[str]:
    """The quantization mode of the artifact at ``ckpt_dir``, or None if
    the directory is not a pre-quantized artifact (e.g. a plain HF
    checkpoint)."""
    if not ckpt_dir:
        return None
    path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f).get("mode")


def load_quantized_artifact(spec: ModelSpec, ckpt_dir: str, mode: str, device="cuda",
                            mesh=None) -> Dict:
    """Load a pre-quantized artifact into the engine's param dict on
    ``device``, one tensor at a time.  Under a ``mesh`` each leaf is read
    and then cut to this rank's slice (``parallel.sharding.shard_leaf``:
    a row-parallel int4 weight's contiguous rows repacked), as the JAX
    loader places each leaf with its sharding.

    Raises ``ValueError`` when the artifact's mode, model name, or any
    model dimension doesn't match what the caller configured — a
    silently mismatched artifact would serve the wrong weights at the
    wrong capacity (and matching num_layers/hidden/vocab alone can hide
    a wrong head or MLP split)."""
    with open(os.path.join(ckpt_dir, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != _FORMAT:
        raise ValueError(
            f"unknown artifact format {manifest.get('format')!r} in {ckpt_dir}"
        )
    if manifest["mode"] != mode:
        raise ValueError(
            f"artifact at {ckpt_dir} is {manifest['mode']}-quantized but "
            f"config.quantization={mode!r}; re-quantize or match the config"
        )
    if manifest.get("model") != spec.name:
        raise ValueError(
            f"artifact at {ckpt_dir} was saved for model "
            f"{manifest.get('model')!r}, not {spec.name!r}"
        )
    for field in (
        "num_layers", "hidden_size", "vocab_size",
        "num_heads", "num_kv_heads", "head_dim", "intermediate_size",
    ):
        if field in manifest and manifest[field] != getattr(spec, field):
            raise ValueError(
                f"artifact {field}={manifest[field]} does not match "
                f"spec {spec.name!r} ({getattr(spec, field)})"
            )
    from bcg_tpu_torch.models.convert import dense_leaf, quantized_leaf
    from bcg_tpu_torch.models.safetensors_np import SafetensorsFile
    from bcg_tpu_torch.models.transformer import param_plan

    from bcg_tpu_torch.parallel.sharding import shard_leaf

    dtypes = manifest["dtypes"]
    plan = {name: shape for name, _, shape in param_plan(spec)}
    # A tied-embedding model's quantized head rides along.
    plan.setdefault("lm_head", (spec.hidden_size, spec.vocab_size))

    def restore(f: SafetensorsFile, name: str) -> torch.Tensor:
        arr = f.numpy(name)
        if dtypes.get(name) == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(device, copy=True)

    params: Dict = {}

    def read_file(path: str) -> None:
        with SafetensorsFile(path) as f:
            leaves: Dict[str, Dict[str, torch.Tensor]] = {}
            for name in f.keys():
                base, _, part = name.rpartition(".")
                if part in ("q", "scale", "q4", "gscale"):
                    leaves.setdefault(base, {})[part] = restore(f, name)
                else:
                    leaf = dense_leaf(name, restore(f, name), plan[name], device, None)
                    params[name] = shard_leaf(name, leaf, spec, mesh, plan[name])
            for base, parts in leaves.items():
                leaf = quantized_leaf(base, parts, plan[base], device)
                params[base] = shard_leaf(base, leaf, spec, mesh, plan[base])

    read_file(os.path.join(ckpt_dir, "top.safetensors"))
    for i in range(spec.num_layers):
        read_file(os.path.join(ckpt_dir, f"layer_{i:04d}.safetensors"))
    return params


# Non-weight files a serve-ready artifact must carry along (the engine
# boots the tokenizer/template from the same directory, exactly like
# real pre-quantized hub repos ship tokenizer + config beside weights).
_SIDECAR_FILES = (
    "config.json",
    "generation_config.json",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
    "vocab.json",
    "merges.txt",
    "tokenizer.model",
)


def convert_checkpoint(model: str, mode: str, out_dir: str, device="cuda") -> None:
    """HF safetensors checkpoint -> pre-quantized artifact (streamed:
    each weight is quantized on ``device`` as it loads, so the bf16 tree
    never exists whole — the same discipline as engine boot).  Tokenizer
    and config sidecar files are copied so the artifact directory is a
    complete, bootable checkpoint."""
    import shutil

    from bcg_tpu_torch.models.loader import find_checkpoint_dir, load_checkpoint_params
    from bcg_tpu_torch.models.quantize import (
        ensure_quantized_head, quantize_leaf_transform,
    )

    spec = spec_for_model(model)
    src_dir = find_checkpoint_dir(model)
    params = load_checkpoint_params(
        spec, model, device, leaf_transform=quantize_leaf_transform(spec, mode),
        ckpt_dir=src_dir,
    )
    ensure_quantized_head(params, spec, mode=mode)
    save_quantized_artifact(params, spec, mode, out_dir)
    if src_dir:
        for fname in _SIDECAR_FILES:
            src = os.path.join(src_dir, fname)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(out_dir, fname))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description="Convert a local HF checkpoint to a pre-quantized "
        "bcg-tpu artifact (quantize once, serve many)"
    )
    p.add_argument("--model", required=True, help="model name or checkpoint dir")
    p.add_argument("--mode", default="int8", choices=["int8", "int4"])
    p.add_argument("--out", required=True, help="artifact output directory")
    p.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                   help="device the weights are quantized on (default: the card)")
    args = p.parse_args(argv)
    convert_checkpoint(args.model, args.mode, args.out, args.device)
    print(f"saved {args.mode} artifact for {args.model} at {args.out}")


if __name__ == "__main__":
    main()
