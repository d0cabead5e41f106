"""Rows the serving scheduler put into each engine call over the window
(``SchedulerStats.dispatched_rows / dispatches``): how well it merges the
games' calls."""

UNIT = "rows/dispatch"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "serving scheduler (serve/scheduler.py, serve/engine.py)"
MOVES = "decisions_per_s"


def read(run):
    s = run.scheduler
    if not s or not s.get("dispatches"):
        return None
    return s["dispatched_rows"] / s["dispatches"]
