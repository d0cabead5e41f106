"""BAD: a mesh function stores full leaves into the tree it builds."""
import math

import torch


def init_params_sharded(plan, generator, mesh, device):
    params = {}
    for name, kind, shape in plan:
        if kind == "dense":
            w = torch.randn(shape, generator=generator, device=device)
            w.mul_(1.0 / math.sqrt(shape[0]))
            params[name] = w.to(torch.bfloat16)      # BCG-JIT-OUTSHARD
        else:
            params[name] = torch.ones(shape, device=device)  # BCG-JIT-OUTSHARD
    return params
