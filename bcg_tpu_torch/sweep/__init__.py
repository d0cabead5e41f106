"""Sweep service: one command, a thousand games.

The experiment tier every PAPERS.md methodology actually needs —
hundreds of game configs x seeds through ONE shared serving scheduler
with games-as-tenants — composed from the pieces the repo already had:
``serve/`` (continuous batching, SLO histograms), ``parallel/
distributed.py`` (multi-host process groups, hybrid meshes),
``runtime/checkpoint.py`` (mid-game round checkpoints), and
``scripts/consensus_report.py`` (manifest-grouped event merge).

    python -m bcg_tpu_torch.sweep run paper-grid --out /tmp/grid   # 108 games
    python -m bcg_tpu_torch.sweep report /tmp/grid

Programmatic: :func:`run_sweep` / :class:`SweepController`
(:mod:`bcg_tpu_torch.sweep.controller`), specs in :mod:`bcg_tpu_torch.sweep.spec`.
"""

from bcg_tpu_torch.sweep.controller import (
    SweepController,
    completed_job_ids,
    game_end_jobs,
    render_report,
    run_sweep,
)
from bcg_tpu_torch.sweep.spec import (
    JOB_DEFAULTS,
    PRESETS,
    JobSpec,
    expand,
    job_id_for,
    load_spec,
)

__all__ = [
    "JOB_DEFAULTS",
    "JobSpec",
    "PRESETS",
    "SweepController",
    "completed_job_ids",
    "expand",
    "game_end_jobs",
    "job_id_for",
    "load_spec",
    "render_report",
    "run_sweep",
]
