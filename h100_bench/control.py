"""The control of the comparison that decides ``correct``, on the card.

    python3 -m h100_bench.control --workload <cell> --seeds 11,22,33 [--seconds <s>]

For each seed, one run of the cell as the benchmark makes it, then the
same sampled greedy rows read twice: by the float32 reference (the gap of
the program's served tokens, as every run reads it) and by the reference
computed one precision lower (``Reference(control="fp8")``: float8 e4m3
matrix-product inputs and attention operands, the configuration's int4
weights kept where it states them), whose own best token at each
position stands in for the program's.  The limit on ``max_logit_gap``
has to lie between the program's readings and the control's.  The cell's
warm rounds are played, so the window's rows have the history a run's
have; a short ``--seconds`` makes the window one round.  Prints one JSON
line per seed.  The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)

    from h100_bench import run
    from h100_bench.registry import Registry

    registry = Registry()
    cell = registry.cell(args.workload)
    run.prepare_environment(cell.config)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run.execute(cell, seed, args.seconds, False, "cuda", t_start=t_start,
                          registry=registry, with_control=True)
        info = res["info"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": res["correct"],
                          "max_logit_gap": res["checks"]["max_logit_gap"]["value"],
                          "control_max_gap": info.get("control_max_gap"),
                          "mean_logit_gap": info["mean_logit_gap"],
                          "control_mean_gap": info.get("control_mean_gap"),
                          "positions": res["checks"]["greedy_tokens_compared"]["value"],
                          "free_positions": info["free_positions"],
                          "nonzero_gaps": info["nonzero_gaps"],
                          "control_nonzero_gaps": info.get("control_nonzero_gaps"),
                          "limit": res["checks"]["max_logit_gap"]["limit"],
                          "tokens": res["checks"]["greedy_tokens_compared"]["value"],
                          "metrics": res["metrics"], "info": info}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
