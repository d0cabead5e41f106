"""Weights into the port: numpy arrays by logical name -> device tensors,
and random initialisation made on the device.

Both produce the flat parameter dict :mod:`bcg_tpu_torch.models.transformer`
reads, keyed by :func:`~bcg_tpu_torch.models.transformer.param_plan`'s
logical names.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Mapping, Tuple, Union

import numpy as np
import torch

from bcg_tpu_torch.models.configs import ModelSpec
from bcg_tpu_torch.models.quantize import int4_group_for, int8_weight_layout
from bcg_tpu_torch.models.transformer import param_plan

NamedArrays = Union[Mapping[str, np.ndarray], Iterable[Tuple[str, np.ndarray]]]


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload.
        return torch.from_numpy(np.array(arr, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


_QUANT_PARTS = ("q", "scale", "q4", "gscale")


def _quantized_shapes(part_names, shape):
    """Expected shapes of a quantized leaf's parts for a plan ``[in, out]``
    weight: int8 ``q`` [in, out] + ``scale`` [out], or int4 ``q4``
    [in/2, out] + ``gscale`` [in/g, out]."""
    d_in, d_out = shape
    if set(part_names) == {"q", "scale"}:
        return {"q": (d_in, d_out), "scale": (d_out,)}
    if set(part_names) == {"q4", "gscale"}:
        return {"q4": (d_in // 2, d_out), "gscale": (d_in // int4_group_for(d_in), d_out)}
    raise KeyError(f"quantized leaf parts {sorted(part_names)}: expected q/scale or q4/gscale")


def params_from_numpy(named_arrays: NamedArrays, spec: ModelSpec,
                      device="cpu", dtype=torch.bfloat16) -> Dict:
    """Map ``(logical_name, array)`` pairs onto the port's parameter dict.

    Names follow ``param_plan``; the stacked ``scan_layers`` form
    (``"layers.wq"`` with a leading ``[num_layers]`` axis) is unstacked
    into ``"layers.{i}.wq"``.  A quantized weight comes as its parts
    (``"layers.3.wq.q"`` + ``".scale"``, or ``".q4"`` + ``".gscale"``; a
    tied-embedding model may add a quantized ``"lm_head"``) and becomes a
    dict under its logical name, each part in its own dtype.  Every plan
    leaf must be present with its plan shape; unknown names raise.  Other
    leaves are cast to ``dtype`` (``None`` keeps each array's own type)."""
    items = named_arrays.items() if isinstance(named_arrays, Mapping) else named_arrays
    flat: Dict[str, np.ndarray] = {}
    for name, arr in items:
        parts = name.split(".")
        if parts[0] == "layers" and not parts[1].isdigit():
            rest = ".".join(parts[1:])
            for li in range(np.shape(arr)[0]):
                flat[f"layers.{li}.{rest}"] = np.asarray(arr)[li]
        else:
            flat[name] = arr
    quant: Dict[str, Dict[str, np.ndarray]] = {}
    for name in list(flat):
        base, _, part = name.rpartition(".")
        if part in _QUANT_PARTS and base:
            quant.setdefault(base, {})[part] = flat.pop(name)
    plan = {n: tuple(shape) for n, _, shape in param_plan(spec)}
    if spec.tie_embeddings and "lm_head" in quant:
        plan["lm_head"] = (spec.hidden_size, spec.vocab_size)
    names = set(flat) | set(quant)
    unknown = sorted(names - set(plan))
    missing = sorted(set(plan) - names)
    if unknown or missing:
        raise KeyError(f"param names do not match the plan of {spec.name!r}: "
                       f"missing {missing[:5]}, unknown {unknown[:5]}")
    out = {}
    for name, shape in plan.items():
        if name in quant:
            want = _quantized_shapes(quant[name], shape)
            leaf = {}
            for part, arr in quant[name].items():
                t = _to_tensor(arr)
                if tuple(t.shape) != want[part]:
                    raise ValueError(f"{name}.{part}: shape {tuple(t.shape)} != {want[part]}")
                leaf[part] = t.to(device=device)
            if "q" in leaf:
                leaf["q"] = int8_weight_layout(leaf["q"])
            out[name] = leaf
            continue
        t = _to_tensor(flat[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != plan {shape}")
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def init_params(spec: ModelSpec, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16, leaf_transform=None) -> Dict:
    """Random weights with the JAX initializer's distribution: dense
    leaves ~ N(0, 1) / sqrt(fan_in), norm vectors 1, biases 0.  Each leaf
    is drawn on ``device`` from ``generator`` (which must live on that
    device), so an 8B model never passes through host memory.  The values
    differ from ``jax.random``'s: random weights carry no golden-value
    contract, and a parity test converts JAX weights instead.

    ``leaf_transform(logical_name, tensor)`` is applied to each dense leaf
    as it is made (``models/quantize.quantize_leaf_transform``), so a
    quantized model is born one leaf at a time and the full-precision
    model never exists whole."""
    params = {}
    for name, kind, shape in param_plan(spec):
        if kind == "dense":
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            w.mul_(1.0 / math.sqrt(shape[0]))
            leaf = w.to(dtype)
            del w
            params[name] = leaf_transform(name, leaf) if leaf_transform else leaf
            del leaf
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            params[name] = fill(shape, dtype=dtype, device=device)
    return params
