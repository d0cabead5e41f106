"""GOOD: numpy only on the host, outside the capture region; the region
(``step``) computes with torch on the device."""
import math

import numpy as np
import torch


def step(x: torch.Tensor):
    return x * torch.clamp(torch.sqrt(x.abs()), min=1.0) * math.sqrt(2.0)


def plan(n):
    return np.arange(n).reshape(-1, 2)        # host-side planning: fine
