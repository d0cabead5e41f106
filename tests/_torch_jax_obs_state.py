"""Leave the JAX package's process-wide observability state as a test
module found it.

The JAX package keeps one counter registry per process, and several of
its tier-1 tests read it whole (``test_trace_report`` ranks every
counter; the host-sync zero-surface tests expect no ``engine.hostsync.*``
names).  The port's parity tests run the JAX engine beside the port's in
the same worker process, so they restore the registry's names and
values, the HBM ledger's entries (a JAX engine that is never shut down
leaves its charges there, and the next charge republishes them as
gauges), the game-event aggregate and the published summaries when they
finish.
"""

import contextlib

from bcg_tpu.obs import counters as j_counters
from bcg_tpu.obs import game_events as j_game_events
from bcg_tpu.obs import ledger as j_ledger
from bcg_tpu.runtime import metrics as j_metrics

_PUBLISHED = ("LAST_HOSTSYNC", "LAST_GAME_STATS", "LAST_COMPILE_OBS", "LAST_SAMPLER",
              "LAST_KV_POOL", "LAST_SERVE_STATS")


@contextlib.contextmanager
def restored():
    reg = j_counters.REGISTRY
    with reg._lock:
        counters = {n: c._value for n, c in reg._counters.items()}
        gauges = {n: g._value for n, g in reg._gauges.items()}
        hists = {n: (list(h._counts), h._sum, h._count) for n, h in reg._histograms.items()}
    published = {k: getattr(j_metrics, k) for k in _PUBLISHED if hasattr(j_metrics, k)}
    ledger = j_ledger.LEDGER
    with ledger._lock:
        entries = {a: dict(keys) for a, keys in ledger._entries.items()}
        limit = ledger._limit
    try:
        yield
    finally:
        with reg._lock:
            for table, saved in ((reg._counters, counters), (reg._gauges, gauges)):
                for name in list(table):
                    if name in saved:
                        table[name]._value = saved[name]
                    else:
                        del table[name]
            for name in list(reg._histograms):
                if name in hists:
                    h = reg._histograms[name]
                    h._counts[:], h._sum, h._count = hists[name]
                else:
                    del reg._histograms[name]
        with ledger._lock:
            for a, keys in ledger._entries.items():
                keys.clear()
                keys.update(entries.get(a, {}))
            ledger._limit = limit
        j_game_events._reset_aggregate()
        for k, v in published.items():
            setattr(j_metrics, k, v)
