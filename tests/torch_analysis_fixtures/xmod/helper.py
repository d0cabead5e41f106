"""Cross-module fixture, callee side: this module has NO capture root
of its own.  ``scale`` only runs inside a capture region because
entry.py's root calls it — the case the per-module fixpoint cannot see
and the whole-program lift (interproc.propagate_capture_regions) exists
to catch.  The ``.item()`` here must surface as BCG-HOST-SYNC in THIS
file."""


def scale(x, factor):
    peak = x.abs().max().item()  # a host read inside a captured helper
    return x * factor / peak


def offset(x, bias):
    # Not reachable from any capture region: must stay quiet.
    return x + x.sum().item() + bias
