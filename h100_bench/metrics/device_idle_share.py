"""Share of the traced window in which no operation ran on the card: one
minus the union of the device operations' intervals over the traced
window's length, both from the same traced interval."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"
MOVES = "decisions_per_s"


def read(run):
    t = run.trace
    if t is None or not t.device_events or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
