"""One rank of the perf gate's ``fleet`` scenario: the counterpart of the
JAX package's ``tests/_fleet_worker.py`` (the gate is a tool, so its rank
code lives in the package).

:func:`rank_main` runs as one rank of a real two-rank CPU world started by
``parallel/distributed.spawn_world(device_type="cpu")`` (whose
``initialize`` hands the observability plane its process identity), and
exercises the fleet plane end to end:

* starts the metric-shard flusher (``BCG_TPU_METRICS_SHARD_DIR``, set by
  the launcher with a shared ``BCG_TPU_RUN_ID``);
* observes a deterministic per-rank probe set into the ``fleet.probe_ms``
  histogram and the ``fleet.probe`` counter — the gate recomputes the same
  formulas (:data:`PROBE_BOUNDS`, :func:`probe_values`) as the
  single-stream oracle the merged shards must match;
* plays one seeded fake-engine consensus game with game events on, into
  ``events-<rank>.jsonl`` under ``events_dir`` (every rank inherits the
  launcher's environment, so the path comes from the rank);
* the last rank freezes its fleet watermark (``obs/fleet.freeze_watermark``,
  the documented chaos hook), so that rank 0's runtime straggler pass
  must flag it; rank 0 polls ``fleet.check_stragglers`` until it does
  (or a deadline passes — the gate then fails on
  ``fleet.straggler_flagged``).
"""

from __future__ import annotations

import os
import time

# The per-rank probe distribution; the gate's oracle uses the same two.
PROBE_BOUNDS = (5, 10, 25, 50, 100, 250)


def probe_values(rank: int):
    return [((7 * i + 13 * rank) % 240) + 1 for i in range(50)]


def rank_main(events_dir: str) -> None:
    import dataclasses

    from bcg_tpu_torch.config import (
        BCGConfig, EngineConfig, GameConfig, MetricsConfig, NetworkConfig,
    )
    from bcg_tpu_torch.obs import counters as obs_counters, fleet, game_events
    from bcg_tpu_torch.runtime import envflags
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    pid, nproc = fleet.process_index(), fleet.process_count()
    os.environ["BCG_TPU_GAME_EVENTS"] = os.path.join(events_dir, f"events-{pid}.jsonl")
    game_events.reset_sink()
    writer = fleet.maybe_start_shard_writer()
    if writer is None:
        raise RuntimeError("fleet probe: the launcher must set BCG_TPU_METRICS_SHARD_DIR")
    if not fleet.enabled():
        raise RuntimeError(f"fleet probe: the fleet plane is off: {fleet.identity()}")
    if pid == nproc - 1:
        fleet.freeze_watermark()

    hist = obs_counters.histogram("fleet.probe_ms", PROBE_BOUNDS)
    for value in probe_values(pid):
        hist.observe(value)
    obs_counters.inc("fleet.probe", 100 + pid)

    cfg = dataclasses.replace(
        BCGConfig(),
        game=GameConfig(num_honest=4, num_byzantine=1, max_rounds=4, seed=7 + pid),
        network=NetworkConfig(topology_type="fully_connected"),
        engine=EngineConfig(backend="fake"),
        metrics=MetricsConfig(save_results=False),
        verbose=False,
    )
    sim = BCGSimulation(config=cfg)
    try:
        sim.run()
    finally:
        sim.close()
    game_events.reset_sink()  # drain + close this rank's event file

    # Rank 0 polls detection until the frozen rank is flagged; the other
    # ranks linger so their shards stay fresh while it looks.  With
    # detection off (factor 0, the straggler-off injection) rank 0 skips
    # the poll and the fleet.stragglers gauge never appears.
    factor = envflags.get_int("BCG_TPU_FLEET_STRAGGLER_FACTOR")
    if pid == 0 and factor > 0 and nproc > 1:
        deadline = time.monotonic() + 20.0
        poll_s = 0.05
        while time.monotonic() < deadline:
            if fleet.check_stragglers(force=True):
                break
            time.sleep(poll_s)
            poll_s = min(poll_s * 2, 0.4)
    else:
        time.sleep(1.5)
    fleet.flush_shards()
    print(f"FLEET-OK pid={pid} watermark={obs_counters.value('fleet.watermark', 0)} "
          f"stragglers={obs_counters.value('fleet.stragglers', 0)}", flush=True)
