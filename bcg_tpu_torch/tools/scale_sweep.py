"""The scale sweep over a world of ranks: N agents play one game through
the sweep tier, each decision and vote batch split one share a rank over
``dp`` and the exchange one ``all_gather`` (``--spmd-exchange``) — the
counterpart of ``scripts/scale_sweep.py``.

    python -m bcg_tpu_torch.tools.scale_sweep [--agents N] [--rounds R]
        [--ranks N] [--device {cuda,cpu}] [--model M] [--max-model-len L]
        [--decide-tokens T] [--vote-tokens T] [--seed S] [--sweep-dir DIR]

``dp`` is the largest divisor of ``--agents`` that is at most ``--ranks``
(default: the cards of this host on CUDA, 1 on the CPU), as the JAX
script takes it from its devices.  With ``dp > 1`` the tool starts a
world of ``dp`` ranks (``parallel/distributed.spawn_world``: a card a
rank, ranks sharing the cards there are over gloo, or the CPU over gloo
with ``--device cpu``; a wall limit, and one rank's failure fails the
world), and every rank runs the same one-job spec through
``sweep.run_sweep`` (backend ``torch``, ``data_parallel_size = dp``, the
SPMD exchange on, one game at a time, no linger): the sweep's cooperative
mode, in which every rank plays the game and rank 0 records it.  With
``dp = 1`` the sweep runs in this process, with no world.  A falsy
``--max-model-len``, ``--decide-tokens`` or ``--vote-tokens`` means the
engine's or ``LLMConfig``'s default.

Emits ONE JSON line with the JAX script's keys: {agents, devices, dp,
model, rounds, rounds_per_sec, decisions_per_sec, dp_batches,
dp_bypasses, sp_bypasses, spmd_mesh_dp, consensus}; ``devices`` is
``--ranks``.  A job already completed in ``--sweep-dir`` is reported from
its manifest record.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Any, Dict, List, Optional

# The world's wall limit: rank start, weights, the game.
WORLD_LIMIT_S = 3600.0


def dp_for(agents: int, ranks: int) -> int:
    """The largest divisor of ``agents`` that is at most ``ranks``."""
    return next(d for d in range(min(agents, ranks), 0, -1) if agents % d == 0)


def job_spec(args, dp: int) -> Dict[str, Any]:
    """The one-job sweep spec the JAX script builds, on the torch backend."""
    return {
        "name": f"scale-{args.agents}",
        "base": {
            "agents": args.agents,
            "byzantine": args.agents // 4,
            "max_rounds": args.rounds,
            "seed": args.seed,
            "backend": "torch",
            "model": args.model,
            "max_model_len": args.max_model_len,
            "data_parallel_size": dp,
            "spmd_exchange": True,
            "decide_tokens": args.decide_tokens,
            "vote_tokens": args.vote_tokens,
        },
        "axes": {},
    }


def _sweep(spec, out_dir: str, device: str, hook: Optional[str]) -> Dict[str, Any]:
    """This process's sweep.  ``hook`` (``"module:function"``) is called as
    ``hook(run, out_dir)``: it must call ``run()`` (which runs the sweep
    and returns its summary) and return the summary — a probe of a rank's
    engine around the sweep (the tests' and the card script's)."""
    from bcg_tpu_torch.parallel.distributed import resolve
    from bcg_tpu_torch.sweep import run_sweep

    def run():
        return run_sweep(spec, out_dir, max_concurrent=1, linger_ms=0, device=device)

    return resolve(hook)(run, out_dir) if hook else run()


def rank_main(spec: Dict[str, Any], out_dir: str, device: str, result: str,
              hook: Optional[str] = None) -> None:
    """One rank of the world (a ``spawn_world`` target): the sweep, rank
    0's summary written to ``result``.  A failed job fails the rank, and
    so the world."""
    import torch.distributed as dist

    summary = _sweep(spec, out_dir, device, hook)
    if dist.get_rank() == 0:
        with open(result, "w") as f:
            json.dump(summary, f, default=str)
    if summary["failed"]:
        raise RuntimeError("scale sweep: a job failed on rank "
                           f"{dist.get_rank()}: {json.dumps(summary, default=str)}")


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(prog="python -m bcg_tpu_torch.tools.scale_sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--agents", type=int, default=16,
                    help="total agents; byzantine count is agents//4")
    ap.add_argument("--rounds", type=int, default=4, help="max game rounds")
    ap.add_argument("--model", default="bcg-tpu/tiny-test")
    ap.add_argument("--max-model-len", type=int, default=512)
    ap.add_argument("--decide-tokens", type=int, default=48)
    ap.add_argument("--vote-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--sweep-dir", default=None,
                    help="sweep dir for the manifest/events (default: a "
                    "fresh temp dir — this tool is a metrics probe)")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks (devices) to spread the agents over (default: "
                    "the cards of this host on cuda, 1 on the cpu)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device of every rank (default: cuda)")
    return ap.parse_args(argv)


def run(argv: Optional[List[str]] = None, *, hook: Optional[str] = None,
        limit_s: float = WORLD_LIMIT_S) -> Dict[str, Any]:
    """Parse ``argv``, run the sweep and return the JSON row; raises on a
    failed job or world.  ``hook``: see :func:`_sweep`, called on every
    rank."""
    args = parse_args(argv)
    ranks = args.ranks
    if ranks is None:
        import torch

        ranks = torch.cuda.device_count() if args.device == "cuda" else 1
    if ranks < 1:
        raise ValueError(f"--ranks {ranks}: no device to run on (--device {args.device})")
    dp = dp_for(args.agents, ranks)
    spec = job_spec(args, dp)
    out_dir = args.sweep_dir or tempfile.mkdtemp(prefix="bcg-scale-sweep-")
    os.makedirs(out_dir, exist_ok=True)
    if dp > 1:
        from bcg_tpu_torch.parallel import distributed

        result = os.path.join(out_dir, "scale-sweep-summary.json")
        distributed.spawn_world("bcg_tpu_torch.tools.scale_sweep:rank_main", dp,
                                timeout_s=limit_s, device_type=args.device,
                                args=dict(spec=spec, out_dir=out_dir, device=args.device,
                                          result=result, hook=hook))
        with open(result) as f:
            summary = json.load(f)
    else:
        summary = _sweep(spec, out_dir, args.device, hook)
        if summary["failed"]:
            raise RuntimeError(f"scale sweep: a job failed: {json.dumps(summary, default=str)}")
    if summary["results"]:
        job = summary["results"][0]
    else:
        # Resume path: the job already completed in this --sweep-dir on a
        # previous invocation — its row comes from the manifest record.
        from bcg_tpu_torch.sweep import completed_job_ids, expand

        jid = expand(spec)[0].job_id
        job = completed_job_ids(out_dir).get(jid)
        if job is None:
            raise RuntimeError(f"scale sweep: no result and no completed record of {jid} "
                               f"in {out_dir}: {json.dumps(summary, default=str)}")
        print(f"scale_sweep: job {jid} already completed in {out_dir}; reporting the "
              "recorded result (use a fresh --sweep-dir to re-measure)", file=sys.stderr)
    eng = job.get("engine") or {}
    return {
        "agents": args.agents,
        "devices": ranks,
        "dp": dp,
        "model": args.model,
        "rounds": job.get("rounds", 0),
        "rounds_per_sec": job.get("rounds_per_sec", 0.0),
        "decisions_per_sec": job.get("decisions_per_sec", 0.0),
        "dp_batches": eng.get("dp_batches"),
        "dp_bypasses": eng.get("dp_bypasses"),
        "sp_bypasses": eng.get("sp_bypasses"),
        "spmd_mesh_dp": job.get("spmd_mesh_dp"),
        "consensus": bool(job.get("converged")),
    }


def main(argv: Optional[List[str]] = None) -> int:
    try:
        row = run(argv)
    except RuntimeError as exc:   # a failed job, or the world's WorldFailed
        print(f"scale_sweep: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
