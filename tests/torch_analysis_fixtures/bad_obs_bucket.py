"""Seeded BCG-OBS-BUCKET violations: hand-rolled bucket counters —
bounds encoded in counter/gauge names instead of a first-class
Histogram (3 findings)."""
from bcg_tpu_torch.obs import counters as obs_counters

_BUCKETS_MS = (1, 5, 10)


def record(ms):
    for bound in _BUCKETS_MS:                     # finding 1: le_ label
        if ms <= bound:
            obs_counters.inc(f"serve.linger_le_{bound}ms")
            return
    obs_counters.inc("serve.linger.bucket.overflow")   # finding 2: bucket
    obs_counters.set_gauge("serve.wait<=10ms", 1)      # finding 3: <=
