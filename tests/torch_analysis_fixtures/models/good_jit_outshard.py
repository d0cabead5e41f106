"""GOOD: each leaf made whole is sliced before it joins the tree."""
import math

import torch

from bcg_tpu_torch.parallel.sharding import shard_leaf


def init_params_sharded(spec, plan, generator, mesh, device, leaf_transform=None):
    params = {}
    for name, kind, shape in plan:
        if kind == "dense":
            w = torch.randn(shape, generator=generator, device=device)
            w.mul_(1.0 / math.sqrt(shape[0]))
            leaf = w.to(torch.bfloat16)
        else:
            leaf = torch.ones(shape, device=device)
        if leaf_transform is not None:
            params[name] = leaf_transform(name, leaf)
        else:
            leaf = shard_leaf(name, leaf, spec, mesh, shape)
            params[name] = leaf
    return params


def init_params(plan, device):
    # No mesh: the one-device tree is whole by design.
    return {name: torch.zeros(shape, device=device) for name, _, shape in plan}
