"""Seeded BCG-OBS-NAME violations: metric names off the taxonomy
(6 findings)."""
from bcg_tpu_torch.obs import counters as obs_counters


def record(entry):
    obs_counters.inc("Serve.Requests")            # finding 1: uppercase
    obs_counters.set_gauge("requests", 1)         # finding 2: one segment
    obs_counters.inc(f"{entry}.retrace")          # finding 3: no static
    #                                               subsystem prefix
    obs_counters.histogram("RoundMs", (1, 5))     # finding 4: histogram
    #                                               names are checked too
    obs_counters.inc("warp.requests")             # finding 5: unknown
    #                                               subsystem (namespace fork)
    obs_counters.inc("alerts.fired")              # finding 6: the registered
    #                                               subsystem is 'alert',
    #                                               singular — 'alerts' forks it
