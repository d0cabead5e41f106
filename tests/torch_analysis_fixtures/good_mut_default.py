"""GOOD: None-default with in-body init."""


def append_to(x, acc=None):
    if acc is None:
        acc = []
    acc.append(x)
    return acc
