"""GOOD: branches on defaulted (host-side) parameters, shapes and
None-checks only (the test declares ``f`` a capture root)."""
import torch


def f(x, bias=None, mode="scale"):
    if mode == "scale":            # defaulted host value: fine
        x = x * 2
    if bias is not None:           # optional-arg idiom: fine
        x = x + bias
    if x.shape[0] > 4:             # shape metadata: fine
        x = x[:4]
    return torch.where(x > 0, x, torch.zeros_like(x))  # device select
