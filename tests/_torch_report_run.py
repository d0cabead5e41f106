"""One run of either package with its observability sinks on, in a process
of its own (a fresh counter registry), for ``tests/test_torch_reports.py``:

    python tests/_torch_report_run.py PACKAGE MODE OUT_DIR

``PACKAGE`` is ``bcg_tpu`` or ``bcg_tpu_torch``.  ``MODE``:

* ``fake``: one fake-engine game (4 honest + 1 Byzantine, seed 7, the
  perf gate's consensus game) with the tracer, the host-sync auditor,
  compile accounting and the game-event stream on, metric shards of run
  ``reports``;
* ``engine`` (the port only): one round of a 2 honest + 1 Byzantine game
  on the tiny ``TorchEngine`` on the CPU, the launch census on too;
* ``alerts``: the perf gate's alert recipe, a fake-engine serving run
  under a crash, a hang and a pool exhaustion with the alert plane on
  (its evaluator parked, every cycle driven here).

Writes ``events.jsonl``, ``trace.json``, ``compile.jsonl`` and
``shards/`` (or ``alerts.jsonl``) under ``OUT_DIR``, and ``figures.json``:
what the run's own modules counted, for the reports to agree with.
"""

import dataclasses
import importlib
import json
import os
import sys
import threading

PAYLOAD_USER = ("Round 2. agent_1 value: 17. agent_2 value: 17. "
                "Your current value: 17. Decide.")
DECISION = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 25},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
        "public_reasoning": {"type": "string", "minLength": 1, "maxLength": 25},
    },
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False,
}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def play(pkg, mode, out):
    cfg_mod = mod(pkg, "config")
    if mode == "fake":
        game = cfg_mod.GameConfig(num_honest=4, num_byzantine=1, max_rounds=6, seed=7)
        engine_cfg = cfg_mod.EngineConfig(backend="fake")
    else:
        game = cfg_mod.GameConfig(num_honest=2, num_byzantine=1, max_rounds=1, seed=0)
        engine_cfg = cfg_mod.EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test")
    cfg = dataclasses.replace(cfg_mod.BCGConfig(), game=game, engine=engine_cfg,
                              metrics=cfg_mod.MetricsConfig(save_results=False),
                              verbose=False)
    engine = None
    if mode == "engine":
        engine = mod(pkg, "engine.torch_engine").TorchEngine(engine_cfg, device="cpu")
    sim = mod(pkg, "runtime.orchestrator").BCGSimulation(config=cfg, engine=engine)
    try:
        stats = sim.run()
    finally:
        sim.close()
    hostsync = mod(pkg, "obs.hostsync").summary()
    compile_brief = mod(pkg, "obs.compile").brief()
    figures = {"rounds": stats["total_rounds"], "host_syncs_total": hostsync["total"],
               "compile": compile_brief}
    if mode == "engine":
        figures["census"] = mod(pkg, "obs.hlo").snapshot()
    mod(pkg, "obs.tracer").flush()
    fleet = mod(pkg, "obs.fleet")
    fleet.flush_shards()
    fleet.reset()
    mod(pkg, "obs.game_events").reset_sink()
    mod(pkg, "obs.compile").reset()
    return figures


def alerts(pkg, out):
    """The perf gate's alert scenario's chaos arm, as in both gates."""
    obs_alerts = mod(pkg, "obs.alerts")
    FakeEngine = mod(pkg, "engine.fake").FakeEngine
    Scheduler = mod(pkg, "serve.scheduler").Scheduler
    sched = Scheduler(
        FakeEngine(seed=0, policy="consensus"), linger_ms=0, bucket_rows=4,
        max_queue_rows=4096, deadline_ms=0, strict_admission=False,
        max_dispatch_retries=2, watchdog_s=1.5,
        engine_factory=lambda: FakeEngine(seed=0, policy="consensus"),
    )
    obs_alerts.evaluate_now()
    payload = [("agent system prompt", PAYLOAD_USER, DECISION)] * 2

    def one_request():
        sched.submit_and_wait(("json",), list(payload), [0.0] * 2, [64] * 2)

    for _wave in range(2):
        pool = [threading.Thread(target=one_request) for _ in range(8)]
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        obs_alerts.evaluate_now()
    sched.close()
    for _ in range(2):
        obs_alerts.evaluate_now()
    eng = obs_alerts.engine()
    figures = {"fired": eng.fired, "resolved": eng.resolved}
    obs_alerts.reset()
    return figures


def main(pkg, mode, out):
    os.makedirs(out, exist_ok=True)
    # Straggler detection runs on the shard writer's wall-clock period, so
    # whether a run publishes its gauge depends on the run's length: off.
    env = {"BCG_TPU_RUN_ID": "reports", "BCG_TPU_FLEET_STRAGGLER_FACTOR": "0"}
    if mode == "alerts":
        env.update(BCG_TPU_ALERTS="1", BCG_TPU_ALERT_MS="3600000",
                   BCG_TPU_ALERT_EVENTS=os.path.join(out, "alerts.jsonl"),
                   BCG_TPU_CHAOS=("seed=7;crash@serve.dispatch:2;hang@serve.dispatch:4:4.0;"
                                  "exhaust@serve.dispatch:6"))
    else:
        env.update(BCG_TPU_TRACE="1", BCG_TPU_TRACE_OUT=os.path.join(out, "trace.json"),
                   BCG_TPU_HOSTSYNC="1", BCG_TPU_COMPILE_OBS=os.path.join(out, "compile.jsonl"),
                   BCG_TPU_GAME_EVENTS=os.path.join(out, "events.jsonl"),
                   BCG_TPU_METRICS_SHARD_DIR=os.path.join(out, "shards"))
        if mode == "engine":
            env["BCG_TPU_HLO_CENSUS"] = "1"
    os.environ.update(env)
    if pkg == "bcg_tpu":
        import jax

        jax.config.update("jax_platforms", "cpu")
    figures = alerts(pkg, out) if mode == "alerts" else play(pkg, mode, out)
    with open(os.path.join(out, "figures.json"), "w") as f:
        json.dump(figures, f)


if __name__ == "__main__":
    main(*sys.argv[1:4])
