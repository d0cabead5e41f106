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
from bcg_tpu_torch.models.transformer import param_plan

NamedArrays = Union[Mapping[str, np.ndarray], Iterable[Tuple[str, np.ndarray]]]


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16: reinterpret the 16-bit payload.
        return torch.from_numpy(np.array(arr, copy=True).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(named_arrays: NamedArrays, spec: ModelSpec,
                      device="cpu", dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Map ``(logical_name, array)`` pairs onto the port's parameter dict.

    Names follow ``param_plan``; the stacked ``scan_layers`` form
    (``"layers.wq"`` with a leading ``[num_layers]`` axis) is unstacked
    into ``"layers.{i}.wq"``.  Every plan leaf must be present with its
    plan shape; unknown names raise.  Leaves are cast to ``dtype``
    (``None`` keeps each array's own type)."""
    items = named_arrays.items() if isinstance(named_arrays, Mapping) else named_arrays
    flat: Dict[str, np.ndarray] = {}
    for name, arr in items:
        parts = name.split(".")
        if parts[0] == "layers" and len(parts) == 2:
            for li in range(np.shape(arr)[0]):
                flat[f"layers.{li}.{parts[1]}"] = np.asarray(arr)[li]
        else:
            flat[name] = arr
    plan = {n: tuple(shape) for n, _, shape in param_plan(spec)}
    unknown = sorted(set(flat) - set(plan))
    missing = sorted(set(plan) - set(flat))
    if unknown or missing:
        raise KeyError(f"param names do not match the plan of {spec.name!r}: "
                       f"missing {missing[:5]}, unknown {unknown[:5]}")
    out = {}
    for name, shape in plan.items():
        t = _to_tensor(flat[name])
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != plan {shape}")
        out[name] = t.to(device=device, dtype=dtype or t.dtype)
    return out


def init_params(spec: ModelSpec, generator: torch.Generator, device="cuda",
                dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Random weights with the JAX initializer's distribution: dense
    leaves ~ N(0, 1) / sqrt(fan_in), norm vectors 1, biases 0.  Each leaf
    is drawn on ``device`` from ``generator`` (which must live on that
    device), so an 8B model never passes through host memory.  The values
    differ from ``jax.random``'s: random weights carry no golden-value
    contract, and a parity test converts JAX weights instead."""
    params = {}
    for name, kind, shape in param_plan(spec):
        if kind == "dense":
            w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
            w.mul_(1.0 / math.sqrt(shape[0]))
            params[name] = w.to(dtype)
            del w
        else:
            fill = torch.ones if kind == "ones" else torch.zeros
            params[name] = fill(shape, dtype=dtype, device=device)
    return params
