"""The whole model step's share of the card's bf16 peak: the operations
the window's requests need (``counts.request_flops``: every prompt and
served token of every served row counted once, whatever the program
caches or skips) over the window's wall seconds times the published
dense bf16 peak (989 TFLOP/s; W4A16 computes in bf16 too).  Read in the
traced run, whose window the profiler slows a little."""

from h100_bench import counts

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step (models/transformer.py)"
MOVES = "decisions_per_s"


def read(run):
    peaks = counts.peaks_for(run.device_name)
    if peaks is None or not run.rows:
        return None
    flops = sum(counts.request_flops(run.model, len(j.prompt), len(j.served))
                for j in run.rows if j.served)
    return 100.0 * flops / (run.window_s * peaks["bf16_flops"])
