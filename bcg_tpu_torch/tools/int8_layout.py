"""Device time of the W8A8 int8 product for each storage order of the
int8 weight, at bench-8b's matmul shapes.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.int8_layout

For each (in, out) weight shape of ``bcg-tpu/bench-8b`` (wq/wo, wk/wv,
w_gate/w_up, w_down, the LM head) and 17, 40 and 64 rows (a decode step's
10 rows padded to 17, a fast-forward chunk, a speculative chunk), times
``torch._int_mm`` with the weight stored row-major ``[in, out]`` and
output-major (``models/quantize.int8_weight_layout``, the transpose of a
contiguous ``[out, in]``), and the bf16 product of the same shape, by
the device time ``torch.profiler`` records for 20 calls.  Checks that
both orders give the same int32 result.  Prints the card's name and
power limit and one JSON line per shape: microseconds per call, and the
kernel names.
"""

from __future__ import annotations

import argparse
import json
import subprocess

SHAPES = ((4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096), (4096, 151936))
ROWS = (17, 40, 64)
CALLS = 20


def device_us(fn):
    """Device microseconds per call of ``fn`` (summed over every kernel it
    launches) and the names of those kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    total, names = 0.0, set()
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            total += evt.duration_ns() / 1e3
            names.add(evt.name()[:80])
    return total / CALLS, sorted(names)


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    from bcg_tpu_torch.models.quantize import int8_weight_layout

    if not torch.cuda.is_available():
        raise SystemExit("int8_layout: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for d_in, d_out in SHAPES:
        row_major = torch.randint(-127, 128, (d_in, d_out), generator=gen, device="cuda",
                                  dtype=torch.int8)
        out_major = int8_weight_layout(row_major)
        w_bf = torch.randn((d_in, d_out), generator=gen, device="cuda").to(torch.bfloat16)
        for m in ROWS:
            x = torch.randint(-127, 128, (m, d_in), generator=gen, device="cuda",
                              dtype=torch.int8)
            same = torch.equal(torch._int_mm(x, row_major), torch._int_mm(x, out_major))
            xb = x.to(torch.bfloat16)
            line = {"shape": [m, d_in, d_out], "equal": same}
            for name, fn in (("row_major", lambda: torch._int_mm(x, row_major)),
                             ("output_major", lambda: torch._int_mm(x, out_major)),
                             ("bf16", lambda: xb @ w_bf)):
                us, kernels = device_us(fn)
                line[f"{name}_us"] = us
                line[f"{name}_kernels"] = kernels
            print("int8_layout: " + json.dumps(line), flush=True)
            if not same:
                raise SystemExit("int8_layout: the two storage orders disagree")
        del row_major, out_major, w_bf
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
