"""Clean metric-name idioms BCG-OBS-NAME must not flag."""
from bcg_tpu_torch.obs import counters as obs_counters


def record(entry, name, account):
    obs_counters.inc("serve.requests")                      # 2 segments
    obs_counters.inc("engine.spec.drafted", 3)              # 3 segments
    obs_counters.set_gauge("engine.hlo.decode_loop.fusions", 7)  # 4 segments
    obs_counters.inc(f"engine.retrace.{entry}")             # prefixed f-string
    obs_counters.set_gauge(f"hbm.{account}_bytes", 0)       # fragment chars ok
    obs_counters.value(name)                                # variable: trusted
    obs_counters.histogram("game.round_ms", (1, 5)).observe(2)  # histogram
    obs_counters.observe("game.round_ms", 3)                # module observe
    obs_counters.set_gauge("fleet.heartbeat_ms", 0)         # fleet subsystem
    obs_counters.inc("sweep.jobs.completed")                # sweep subsystem
    obs_counters.inc("chaos.injected")                      # chaos subsystem
    obs_counters.inc("alert.fired")                         # alert subsystem
    obs_counters.set_gauge("alert.firing.slo_burn", 1)      # per-rule gauge
