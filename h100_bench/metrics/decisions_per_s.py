"""Agent decisions per second: every decide and vote of the window's
whole rounds, over the window's wall seconds (a study's throughput)."""

UNIT = "decisions/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    return run.decisions / run.window_s
