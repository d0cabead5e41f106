"""B2 (the fused guided sampler, ``csrc/guided_sampler.cu``) alone at P1's
shape, one process per source tree.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.sampler_kernel [--inputs FILE] [--rows 10,150]
        [--seed 0] [--tree DIR ...]

Inputs: ``FILE`` as ``python3 chip_smoke.py --save-sampler-inputs FILE``
writes P1's captured call (its even rows made greedy, as ``chip_smoke.py``
does); without it, synthetic rows at bench-8b's vocabulary (V = 151936)
made on the card from the seed for each ``--rows`` count: logits N(0, 9),
60% of the tokens allowed, temperature 0.7, a forbid token on a third of
the rows, even rows greedy.  Each tree (default: this checkout) runs in a
process of its own that imports that tree's ``bcg_tpu_torch``; two trees
run in turns, a b b a, so that two versions of the kernel are compared on
one card.  For each batch and top_p in (1.0, 0.9): token mismatches
against the plain version, whether two calls give the same bits, the
median event-timed ms of single calls, the graph-timed ms (a CUDA graph of
calls over input copies that read twice the 50 MB L2), the bound (each
logit and budget read once at 3.35 TB/s) and the launch plan where the
tree has one.  Prints the card's name and power limit and one JSON line
per measurement; exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
TOP_PS = (1.0, 0.9)


def _event_ms(fn, reps=50):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _cold_graph_ms(fn, args, nbytes):
    """One call's device time: calls over ``args`` and copies of them that
    together read twice the L2, captured in one CUDA graph and replayed."""
    import torch

    n = max(1, min(8, -(-100_000_000 // nbytes)))
    sets = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                     for _ in range(n - 1)]
    calls = [lambda a=a: fn(*a) for a in sets]
    reps = max(20, n)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % n]()
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
    return statistics.median(times)


def _synthetic(B, V, seed):
    import torch

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    big = torch.iinfo(torch.int16).max
    minb = torch.randint(1, 6, (1, B, V), generator=g, device="cuda", dtype=torch.int16)
    minb[torch.rand((1, B, V), generator=g, device="cuda") < 0.4] = big
    fb = torch.randint(0, V, (B,), generator=g, device="cuda", dtype=torch.int32)
    fb[torch.rand(B, generator=g, device="cuda") >= 1 / 3] = -1
    meta_i = torch.stack([torch.full((B,), 8, dtype=torch.int32, device="cuda"), fb,
                          (torch.arange(B, device="cuda") % 2 == 0).to(torch.int32),
                          torch.ones(B, dtype=torch.int32, device="cuda")], 1).contiguous()
    meta_f = torch.stack([torch.full((B,), 0.7, device="cuda"),
                          torch.rand(B, generator=g, device="cuda")], 1).contiguous()
    logits = torch.randn((B, V), generator=g, device="cuda") * 3
    return (logits, minb, torch.zeros(B, dtype=torch.int32, device="cuda"),
            torch.arange(B, dtype=torch.int32, device="cuda"), meta_i, meta_f, 3)


def _captured(path):
    import torch

    d = torch.load(path, map_location="cuda")
    mi = d["meta_i"].clone()
    mi[:, 2] = (torch.arange(mi.shape[0], device="cuda") % 2 == 0).to(torch.int32)
    return (d["logits"], d["min_budget"], d["dfa_ids"], d["states"], mi, d["meta_f"],
            d["eos_id"])


def child(tree, args):
    """Measure the kernel of ``tree`` (imported from there) and print one
    JSON line per batch and top_p; returns the mismatch count."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from bcg_tpu_torch.ops import guided_sampler as gs

    if not os.path.abspath(gs.__file__).startswith(os.path.abspath(tree) + os.sep):
        raise RuntimeError(f"imported {gs.__file__}, not the tree {tree}")
    calls = ([_captured(args.inputs)] if args.inputs else
             [_synthetic(int(b), 151936, args.seed) for b in args.rows.split(",") if b])
    bad = 0
    for logits, minb, dfa_ids, states, mi, mf, eos in calls:
        B, V = logits.shape
        base = (logits, minb, dfa_ids, states, mi, mf)
        for top_p in TOP_PS:
            tok, any_tok = gs.sample_rows_cuda(*base, eos, top_p)
            tok2, _ = gs.sample_rows_cuda(*base, eos, top_p)
            ref, ref_any = gs.sample_rows_plain(*base, eos, top_p)
            torch.cuda.synchronize()
            mism = int((tok.long() != ref.long()).sum()) + int((any_tok != ref_any).sum())
            bad += mism
            plan = getattr(gs, "cuda_plan", None)
            print(json.dumps(dict(
                tree=tree, inputs=args.inputs or f"synthetic seed {args.seed}", B=B, V=V,
                top_p=top_p, token_mismatches=mism, same_bits=torch.equal(tok, tok2),
                ms=_event_ms(lambda: gs.sample_rows_cuda(*base, eos, top_p)),
                graph_ms=_cold_graph_ms(gs.sample_rows_cuda, base + (eos, top_p), B * V * 6),
                bound_ms=B * V * 6 / HBM_BYTES_PER_S * 1e3,
                plan=plan(logits.device, B, V, top_p)._asdict() if plan else None)),
                flush=True)
    return bad


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--inputs", default="")
    parser.add_argument("--rows", default="10,150")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--tree", action="append", default=[])
    parser.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sampler_kernel: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        return 1 if child(args.child, args) else 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    trees = args.tree or [here]
    order = trees + trees[::-1] if len(trees) == 2 else trees
    rc = 0
    for tree in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree, "--rows", args.rows,
               "--seed", str(args.seed)] + (["--inputs", args.inputs] if args.inputs else [])
        rc |= subprocess.run(cmd).returncode
    return 1 if rc else 0


if __name__ == "__main__":
    sys.exit(main())
