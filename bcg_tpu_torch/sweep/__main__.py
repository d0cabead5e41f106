"""CLI for the sweep service.

    python -m bcg_tpu_torch.sweep run <preset|spec.json> [--out DIR] [...]
    python -m bcg_tpu_torch.sweep expand <preset|spec.json>
    python -m bcg_tpu_torch.sweep report <DIR>
    python -m bcg_tpu_torch.sweep list

``run`` is resume-safe by construction: re-running the same spec into
the same --out finishes exactly the jobs a killed invocation left
behind (completed jobs are skipped from the sweep manifest /
``game_end`` records; interrupted games continue from their newest
round checkpoint when ``BCG_TPU_SERVE_CHECKPOINT_EVERY`` is set).

Multi-process: every rank runs the same command and joins one
``torch.distributed`` world through ``parallel/distributed.initialize``:
``--coordinator`` (``host:port``, or a ``tcp://`` / ``file://`` init
method) with ``--num-processes`` and ``--process-id``, or ``--distributed``
alone, which reads the world from ``env://`` (``torchrun --nproc-per-node
N -m bcg_tpu_torch.sweep run ... --distributed``).  Every rank then runs
its ``jobs[rank::world]`` partition; a single-job spec instead runs
cooperatively: every rank plays the one game (its SPMD exchange and its
``dp`` batches span the world) and rank 0 alone records it.  ``run
--device cpu`` runs the torch engines on the CPU and joins the world over
gloo (default: the CUDA card).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bcg_tpu_torch.sweep",
        description="Multi-tenant sweep tier: a job grid through one "
        "shared serving scheduler.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="run a sweep (resume-safe)")
    run_p.add_argument("spec", help="preset name or spec JSON path")
    run_p.add_argument("--out", default=None,
                       help="sweep dir (default: BCG_TPU_SWEEP_DIR or "
                       "./sweeps/<name>)")
    run_p.add_argument("--max-concurrent", type=int, default=None,
                       help="games in flight per rank "
                       "(BCG_TPU_SWEEP_MAX_CONCURRENT)")
    run_p.add_argument("--tenant-quota-rows", type=int, default=None,
                       help="per-tenant queued-row quota "
                       "(BCG_TPU_SWEEP_TENANT_QUOTA_ROWS; 0 = unlimited)")
    run_p.add_argument("--slo-ms", type=int, default=None,
                       help="scheduler SLO objective feeding retry-after "
                       "(default BCG_TPU_SERVE_SLO_MS)")
    run_p.add_argument("--json", action="store_true", dest="as_json",
                       help="print the rank summary as JSON")
    run_p.add_argument("--distributed", action="store_true",
                       help="join the multi-process group from env:// "
                       "(torchrun sets it)")
    run_p.add_argument("--coordinator", default=None,
                       help="coordinator address for a manual cluster")
    run_p.add_argument("--num-processes", type=int, default=None)
    run_p.add_argument("--process-id", type=int, default=None)
    run_p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                       help="torch device of the engines the sweep creates "
                       "(default: cuda)")

    exp_p = sub.add_parser("expand", help="print the deterministic job list")
    exp_p.add_argument("spec")

    rep_p = sub.add_parser("report", help="aggregate a sweep dir")
    rep_p.add_argument("out_dir")

    sub.add_parser("list", help="list named presets")

    args = parser.parse_args(argv)

    from bcg_tpu_torch.sweep import controller, spec as sweep_spec

    if args.cmd == "list":
        for name, preset in sweep_spec.PRESETS.items():
            jobs = sweep_spec.expand(preset)
            print(f"{name:>16}  {len(jobs):>4} jobs  "
                  f"axes={sorted(preset.get('axes', {}))}")
        return 0

    if args.cmd == "expand":
        for job in sweep_spec.expand(sweep_spec.load_spec(args.spec)):
            print(json.dumps({"job": job.job_id, **dict(job.params)},
                             sort_keys=True))
        return 0

    if args.cmd == "report":
        print(controller.render_report(args.out_dir))
        return 0

    # run
    if args.distributed or args.coordinator is not None:
        from bcg_tpu_torch.parallel import distributed

        distributed.initialize(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device_type=args.device,
        )
    spec = sweep_spec.load_spec(args.spec)
    out_dir = args.out
    if out_dir is None:
        from bcg_tpu_torch.runtime import envflags

        out_dir = envflags.get_str("BCG_TPU_SWEEP_DIR") or (
            f"sweeps/{sweep_spec.spec_name(spec)}"
        )
    summary = controller.run_sweep(
        spec, out_dir,
        max_concurrent=args.max_concurrent,
        tenant_quota_rows=args.tenant_quota_rows,
        slo_ms=args.slo_ms,
        device=args.device,
    )
    if args.as_json:
        print(json.dumps(summary, indent=2, default=str))
    else:
        print(
            f"sweep {summary['sweep']}: rank {summary['rank']}/"
            f"{summary['world']} ran {summary['completed']} job(s), "
            f"{summary['failed']} failed, {summary['skipped']} already "
            f"done — {summary['out_dir']}"
        )
        print(controller.render_report(out_dir))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
