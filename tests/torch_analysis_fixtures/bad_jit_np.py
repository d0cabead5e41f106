"""BAD: numpy ops inside a capture region (the test declares ``step``
a capture root): computed once on the host and baked into the graph."""
import numpy as np
import torch


def step(x: torch.Tensor):
    scale = np.sqrt(2.0)                      # BCG-JIT-NP
    return x * np.maximum(scale, 1.0)         # BCG-JIT-NP
