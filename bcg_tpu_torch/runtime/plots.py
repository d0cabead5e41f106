"""Per-run plots.

The reference carries a ``METRICS_CONFIG["generate_plots"]`` flag that
nothing reads (SURVEY.md §5.6, "toggled but nothing plots") — here the
flag works.  One PNG per run in ``results/plots/run_NNN.png``:

* value trajectories: every agent's value per round, honest solid /
  Byzantine dashed, consensus value (if reached) as a horizontal band;
* honest agreement percentage per round against the 100%-unanimity
  consensus requirement.

Uses matplotlib's non-interactive Agg backend; cleanly no-ops (returns
None) if matplotlib is unavailable so headless images never crash a run.
"""

from __future__ import annotations

import os
from typing import Optional


def generate_run_plots(game, results_dir: str, run_number: str) -> Optional[str]:
    """Render and save the per-run figure; returns the path or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except (ImportError, RuntimeError):
        # No matplotlib (or no usable backend): plots are best-effort.
        return None
    if not game.rounds:
        return None

    plots_dir = os.path.join(results_dir, "plots")
    os.makedirs(plots_dir, exist_ok=True)
    path = os.path.join(plots_dir, f"run_{run_number}.png")

    rounds = [r.round_num for r in game.rounds]
    agent_ids = sorted(game.rounds[0].agent_values)
    byz = {aid for aid, a in game.agents.items() if a.is_byzantine}

    fig, (ax1, ax2) = plt.subplots(
        2, 1, figsize=(9, 7), sharex=True,
        gridspec_kw={"height_ratios": [2, 1]},
    )

    for aid in agent_ids:
        ys = [r.agent_values.get(aid) for r in game.rounds]
        style = dict(linestyle="--", alpha=0.7) if aid in byz else dict(alpha=0.9)
        ax1.plot(rounds, ys, marker="o", markersize=3,
                 label=f"{aid}{' (byz)' if aid in byz else ''}", **style)
    if game.consensus_reached and game.consensus_value is not None:
        ax1.axhline(game.consensus_value, color="green", linewidth=6, alpha=0.15)
        ax1.annotate(f"consensus = {game.consensus_value}",
                     (rounds[0], game.consensus_value),
                     fontsize=8, color="green", va="bottom")
    lo, hi = game.value_range
    ax1.set_ylim(lo - 1, hi + 1)
    ax1.set_ylabel("proposed value")
    ax1.set_title(
        f"Run {run_number}: {game.num_honest}H+{game.num_byzantine}B, "
        f"{'consensus' if game.consensus_reached else 'no consensus'} "
        f"in {len(game.rounds)} round(s)"
    )
    ax1.legend(fontsize=7, ncol=2, loc="best")

    ax2.plot(rounds, [r.convergence_metric for r in game.rounds],
             marker="s", markersize=3, color="tab:blue")
    ax2.axhline(100.0, color="green", linestyle=":", linewidth=1,
                label="consensus requires 100% honest unanimity")
    ax2.set_ylim(0, 105)
    ax2.set_xlabel("round")
    ax2.set_ylabel("honest agreement %")
    ax2.legend(fontsize=7)
    from matplotlib.ticker import MaxNLocator

    ax2.xaxis.set_major_locator(MaxNLocator(integer=True))

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
