"""Clean distribution idioms BCG-OBS-BUCKET must not flag."""
from bcg_tpu_torch.obs import counters as obs_counters

_hist = obs_counters.histogram("serve.queue_wait_ms", (1, 5, 10))


def record(ms, name):
    _hist.observe(ms)                                  # first-class histogram
    obs_counters.observe("serve.queue_wait_ms", ms)    # module-level observe
    obs_counters.inc("serve.requests")                 # plain counter
    obs_counters.value("serve.queue_wait_ms.bucket.le_5")  # flat READ: legal
    obs_counters.inc(name)                             # variable: trusted
