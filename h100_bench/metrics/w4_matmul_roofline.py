"""B5, the W4A16 matmul kernel, against its bandwidth bound: the int4
weights and bf16 group scales the window's forward passes need (every
layer product and the LM head once per decode step, the engine's own
count of them; the LM head once per engine call's prefill, whose layer
products take the dequantizing route and not B5), at the card's
published 3.35 TB/s, over B5's device time in the traced window."""

from h100_bench import counts

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels: W4A16 matmul (ops/w4_matmul.py, csrc/w4a16.cu)"
MOVES = "decisions_per_s"
KERNELS = ("w4a16_kernel",)


def read(run):
    peaks = counts.peaks_for(run.device_name)
    group = run.bench.get("int4_group")
    if run.trace is None or peaks is None or not group:
        return None
    seconds, launches = run.trace.kernel_seconds(KERNELS)
    steps = run.engine["decode_steps"]
    if not launches or not steps:
        return None
    need = (steps * counts.int4_pass_bytes(run.model, group)
            + run.calls * counts.int4_head_bytes(run.model, group))
    return 100.0 * need / peaks["hbm_bytes_per_s"] / seconds
