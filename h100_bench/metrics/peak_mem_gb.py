"""Peak device memory of the window (``torch.cuda.max_memory_allocated``
reset at window start), in units of 1e9 bytes: what bounds how many
games share a card."""

UNIT = "GB"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
