"""BAD: Python control flow on a non-static parameter of a capture root
(the test declares ``f`` and ``g`` roots): a graph records one side."""
import torch


def f(x, threshold):
    if threshold > 0:              # BCG-JIT-BRANCH
        return x * threshold
    return x


def g(x, n):
    while n > 0:                   # BCG-JIT-BRANCH
        x = x + 1
        n = n - 1
    return x
