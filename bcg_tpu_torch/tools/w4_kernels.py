"""B5 (the W4A16 matmul, ``csrc/w4a16.cu``) against its plain version at
bench-8b's int4 weight shapes with synthetic weights, in one process.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.w4_kernels [--seed 0] [--rows 1,10,50,256]
        [--sweep 1,10] [--route 16,32,64,128,256]

Weights (made on the card from the seed): N(0, 1) / sqrt(in) at Qwen3-8B's
widths (wq/wo 4096 x 4096, wk/wv 4096 x 1024, w_gate/w_up 4096 x 12288,
w_down 12288 x 4096, the LM head 4096 x 151936), quantized to int4 in
groups of 128 as the engine stores them; x N(0, 1) in bf16.  For each
shape and row count: the relative L2 error per output row against the
plain version (limit 1e-3, as ``chip_smoke.py``), whether two calls give
the same bits and one call launches once, the plan, the kernel's time in
a CUDA graph of calls over enough weight copies to read twice the 50 MB
L2, ``torch._weight_int4pack_mm`` over the same int4 weight (the
library's W4A16 product, timed only), the bf16 product over the weight
already dequantized, and the bound.  ``--sweep``: at those row counts,
every plan of column warps and contraction splits that fits shared
memory, each graph-timed (the planner's choice marked).  ``--route``:
at those row counts, B5 against ``quantize.dense``'s other route, the
weight dequantized whole and one bf16 product, the dequantization
counted (where B5 stops paying: ``W4_KERNEL_MAX_ROWS``).  Prints the
card's name and power limit and one JSON line per measurement; exits 1
if the kernel disagrees.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
REL_ROW_TOL = 1e-3
SHAPES = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024), "w_gate/w_up": (4096, 12288),
          "w_down": (12288, 4096), "lm_head": (4096, 151936)}


def _graph_ms(calls, reps):
    """Device time of one call: ``reps`` calls (``calls[i % len]``)
    captured in one CUDA graph, replayed five times, the median per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    del graph
    return statistics.median(times)


def _rel_row(out, ref):
    return ((out.float() - ref).pow(2).sum(-1).sqrt()
            / ref.pow(2).sum(-1).sqrt().clamp_min(1e-30)).max().item()


def _bound(M, D, F, q4, gscale):
    byts = q4.numel() + 2 * gscale.numel() + 2 * M * D + 4 * M * F
    tb, tf = byts / HBM_BYTES_PER_S * 1e3, 2 * M * D * F / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def _int4pack(q4, gscale):
    """The weight in ``torch._weight_int4pack_mm``'s layout (as
    ``chip_smoke.py`` converts it): unsigned nibbles of the transposed
    weight, two a byte, and [D/g, F, 2] scales with zero points 0."""
    import torch

    from bcg_tpu_torch.ops.w4_matmul import unpack_int4

    u = (unpack_int4(q4).to(torch.int32) + 8).t().contiguous()
    w = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 2)
    return w, torch.stack([gscale, torch.zeros_like(gscale)], dim=-1).contiguous()


def _candidates(M, P, F, sms):
    """Every plan of column warps and contraction splits whose x fits
    shared memory, with the planner's row tiling and column blocks."""
    from bcg_tpu_torch.ops import w4_matmul as w4

    nt = 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8
    mblocks, rows = -(-M // (8 * nt)), min(M, 8 * nt)
    nchunk = -(-P // 64)
    for wc in (1, 2, 4, 8, 16):
        tiles = -(-F // (16 * wc))
        for splits in (1, 2, 3, 4, 6, 8, 12, 16):
            cps = -(-nchunk // splits)
            if -(-nchunk // cps) != splits or w4.smem_bytes(nt, wc, rows, cps * 64) > \
                    w4.SMEM_BUDGET:
                continue
            per_row = splits * mblocks
            gx = tiles if tiles * per_row <= sms else max(1, sms // per_row)
            yield w4.W4Plan(nt, wc, splits, cps * 64, gx, mblocks)


def run_shape(name, D, F, gen, rows, sweep, route):
    import torch

    from bcg_tpu_torch.models.quantize import dequantize_int4, quantize_weight_int4
    from bcg_tpu_torch.ops import w4_matmul as w4

    w = torch.randn((D, F), generator=gen, device="cuda") / D ** 0.5
    q = quantize_weight_int4(w.to(torch.bfloat16))
    del w
    q4, gs = q["q4"], q["gscale"]
    P = q4.shape[0]
    copies = max(1, min(64, -(-100_000_000 // q4.numel())))
    ws = [(q4, gs)] + [(q4.clone(), gs.clone()) for _ in range(copies - 1)]
    reps = max(20, copies)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    packs = [_int4pack(a, b) for a, b in ws]
    lines, ok = [], True
    for M in sorted(set(rows) | set(sweep) | set(route)):
        x = torch.randn((M, D), generator=gen, device="cuda").to(torch.bfloat16)
        plan = w4.split_plan(M, P, F, sms)

        def kernel(p=None):
            return [lambda a=a, b=b: w4.w4a16_matmul_cuda(x, a, b, p) for a, b in ws]

        bms, by = _bound(M, D, F, q4, gs)
        line = dict(shape=name, M=M, D=D, F=F, plan=list(plan), bound_ms=bms, bound_by=by)
        if M in rows:
            before = w4.w4a16_matmul.launches
            out = w4.w4a16_matmul_cuda(x, q4, gs)
            again = w4.w4a16_matmul_cuda(x, q4, gs)
            torch.cuda.synchronize()
            ref = w4.w4a16_matmul_plain(x, q4, gs)
            line.update(rel_row=_rel_row(out, ref), identical=bool(torch.equal(out, again)),
                        launches_per_call=(w4.w4a16_matmul.launches - before) / 2)
            ok &= line["rel_row"] <= REL_ROW_TOL and line["identical"]
            ok &= line["launches_per_call"] == 1
            lib = torch._weight_int4pack_mm(x, packs[0][0], 128, packs[0][1])
            line["library_rel_row"] = _rel_row(lib, ref)
            del out, again, ref, lib
            line["ms"] = _graph_ms(kernel(), reps)
            line["library_ms"] = _graph_ms(
                [lambda a=a, b=b: torch._weight_int4pack_mm(x, a, 128, b) for a, b in packs],
                reps)
            w_bf = [dequantize_int4({"q4": a, "gscale": b}) for a, b in ws[:max(1, copies // 4)]]
            line["dequantized_bf16_matmul_ms"] = _graph_ms(
                [lambda b=b: torch.matmul(x, b) for b in w_bf], reps)
            del w_bf
        if M in route:
            line["route_b5_ms"] = line.get("ms") or _graph_ms(kernel(), reps)
            line["route_dequantize_matmul_ms"] = _graph_ms(
                [lambda a=a, b=b: x @ dequantize_int4({"q4": a, "gscale": b})
                 for a, b in ws[:2]], 4)
        if M in sweep:
            line["sweep"] = sorted(
                (_graph_ms(kernel(p), reps), list(p)) for p in _candidates(M, P, F, sms))
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    return ok


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rows", default="1,10,50,256")
    parser.add_argument("--sweep", default="")
    parser.add_argument("--route", default="")
    parser.add_argument("--shapes", default=",".join(SHAPES))
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("w4_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)

    def ints(s):
        return [int(v) for v in s.split(",") if v]

    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    ok = True
    for name in args.shapes.split(","):
        ok &= run_shape(name, *SHAPES[name], gen, ints(args.rows), ints(args.sweep),
                        ints(args.route))
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
