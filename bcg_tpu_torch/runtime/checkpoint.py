"""Per-round checkpoint / resume.

The reference persists only terminal artifacts — a crashed 50-round run
loses everything (SURVEY.md §5.4).  Game + agent memories are a small JSON
blob; model weights never need checkpointing (inference only), so resume
cost is one engine warm-up.
"""

from __future__ import annotations

import json
import os


def save_checkpoint(sim, path: str) -> str:
    """Serialize simulation state (game, agent memories, network round)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob = {
        "version": 2,
        "run_number": sim.run_number,
        "game": sim.game.snapshot(),
        "agents": {aid: agent.snapshot() for aid, agent in sim.agents.items()},
        "network_round": sim.network.current_round,
    }
    # Channel state: in-flight (delayed) messages, fault-RNG position,
    # counters — without it a resumed lossy_sim run silently loses
    # delayed proposals and replays the fault RNG from its initial seed.
    snap = getattr(sim.network.protocol, "snapshot", None)
    if snap is not None:
        blob["protocol"] = snap()
    # Writer-unique tmp name: a cooperative sweep's ranks (and any
    # other concurrent writers of the same lockstep game) checkpoint
    # the same FINAL path — a shared "<path>.tmp" let one rank's
    # os.replace steal the other's half-written file out from under it
    # (FileNotFoundError on the loser's rename).  Per-pid tmps never
    # collide; the last atomic rename wins with identical content.
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, path)  # atomic
    return path


def load_checkpoint(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resume_simulation(path: str, config=None, engine=None,
                      sweep_job_id=None):
    """Rebuild a :class:`BCGSimulation` from a checkpoint.

    The restored game is authoritative: agents are re-created from ITS
    Byzantine assignment (a fresh, unseeded simulation would otherwise
    roll different roles than the checkpoint), then their memories are
    restored.  ``sim.run()`` continues from the next round under the
    original run number, appending to the original log.
    ``sweep_job_id`` re-stamps the sweep tier's job identity on the
    resumed game's event records (bcg_tpu/sweep resume path).
    """
    from bcg_tpu_torch.config import BCGConfig
    from bcg_tpu_torch.game import ByzantineConsensusGame
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    blob = load_checkpoint(path)
    config = config or BCGConfig()
    sim = BCGSimulation(
        config=config,
        engine=engine,
        run_number=blob["run_number"],
        log_mode="a",
        sweep_job_id=sweep_job_id,
    )
    sim.game = ByzantineConsensusGame.from_snapshot(blob["game"])
    # Re-create agents against the restored game's roles (the initial
    # construction used a freshly-rolled game whose Byzantine assignment
    # need not match the checkpoint).
    sim.agents = {}
    sim._create_agents()
    for aid, agent_blob in blob["agents"].items():
        if aid in sim.agents:
            sim.agents[aid].restore(agent_blob)
            # Initial values feed cached system prompts; re-sync them.
            game_agent = sim.game.agents[aid]
            if game_agent.initial_value is not None:
                sim.agents[aid].set_initial_value(game_agent.initial_value)
                sim.agents[aid].my_value = agent_blob["my_value"]
    sim.network.current_round = blob["network_round"]
    proto_blob = blob.get("protocol")
    restore = getattr(sim.network.protocol, "restore", None)
    if proto_blob is not None and restore is not None:
        restore(proto_blob)
    return sim
