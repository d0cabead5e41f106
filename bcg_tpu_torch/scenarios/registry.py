"""Scenario registry: named adversary experiments as config, not forks.

A :class:`Scenario` bundles one :mod:`~bcg_tpu_torch.scenarios.strategies`
entry with the game shape it is studied under — topology
(``comm/topology.py``), channel (``comm/lossy_sim.py`` via
``drop_prob``), ``byzantine_awareness`` prompt variant (PAPER.md
L1/L3), agent split, and an optional heterogeneous-fleet model (a
strong adversary served next to weak honest rows via ``serve/``'s
per-row signature merging).  Entries expand two ways:

* **sweep presets** — :func:`scenario_params` returns the job-param
  overlay the sweep spec layer applies per job (``bcg_tpu/sweep/spec``
  resolves a ``scenario`` job key through this function; the
  ``adversary-grid`` preset is an axis over :func:`scenario_names`);
* **single runs** — ``BCG_TPU_SCENARIO=<name>`` routes any
  :class:`~bcg_tpu_torch.runtime.orchestrator.BCGSimulation` construction
  through :func:`apply_scenario`, so bench/api/CLI entry points get
  registry-true configs without new plumbing.

Import-light like the strategy library: no jax, loadable by flag-only
consumers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

from bcg_tpu_torch.scenarios.strategies import STRATEGIES, get_strategy


@dataclass(frozen=True)
class Scenario:
    """One named adversary experiment (see module docstring)."""

    name: str
    strategy: str
    doc: str
    topology: str = "fully_connected"
    awareness: str = "may_exist"  # may_exist | none_exist (PAPER.md L1/L3)
    agents: int = 6               # total (honest = agents - byzantine)
    byzantine: int = 2
    max_rounds: int = 6
    # Lossy channel (comm/lossy_sim.py) when > 0; the sweep layer maps
    # this to protocol_type="lossy_sim".
    drop_prob: float = 0.0
    # Heterogeneous fleet: serve the ADVERSARY rows from this model
    # while honest rows keep the job default (None = homogeneous).
    # Rides serve/'s per-row signature merging — rows with different
    # sampling/model signatures already batch separately.
    model: Optional[str] = None

    def __post_init__(self):
        get_strategy(self.strategy)  # fail at definition, not expansion
        if not (0 < self.byzantine < self.agents):
            raise ValueError(
                f"scenario {self.name!r}: byzantine={self.byzantine} "
                f"must be in (0, agents={self.agents})"
            )


SCENARIOS: Dict[str, Scenario] = {
    s.name: s
    for s in (
        Scenario(
            name="baseline-disrupt",
            strategy="disrupt",
            doc="The reference threat model: independent disruptors on "
                "the ideal fully-connected channel.",
        ),
        Scenario(
            name="clique-collusion",
            strategy="clique",
            doc="Two colluders push one seed-derived decoy value — the "
                "shared-target agreement oracle in the perf gate.",
        ),
        Scenario(
            name="adaptive-margin",
            strategy="adaptive",
            doc="Adversary reads honest convergence each round and "
                "targets the consensus margin.",
        ),
        Scenario(
            name="equivocation-split",
            strategy="equivocate",
            doc="Per-receiver proposal tensors: each receiver sees a "
                "different variant of the adversary's value "
                "(divergence visible in the deliveries events).",
        ),
        Scenario(
            name="oscillate-lossy",
            strategy="oscillate",
            doc="Extremes-swinging adversary over a lossy channel — "
                "drops amplify the induced disagreement.",
            drop_prob=0.2,
        ),
        Scenario(
            name="mimic-unaware",
            strategy="mimic",
            doc="Trust-then-strand mimic against honest agents told no "
                "Byzantine agents exist (awareness variant L3).",
            awareness="none_exist",
        ),
        Scenario(
            name="silent-ring",
            strategy="silent",
            doc="Participation-starving adversary on a ring, where each "
                "lost voice blanks a whole neighborhood.",
            topology="ring",
        ),
    )
}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}"
        ) from None


def scenario_names() -> Tuple[str, ...]:
    return tuple(SCENARIOS)


def scenario_params(name: str) -> Dict[str, Any]:
    """The sweep job-param overlay for one registry entry.

    Keys are sweep ``JOB_DEFAULTS`` names; the spec layer applies them
    BETWEEN the defaults and any explicitly-specified base/axis keys
    (explicit keys win — a preset can pin ``agents`` across scenarios).
    """
    s = get_scenario(name)
    params: Dict[str, Any] = {
        "strategy": s.strategy,
        "topology": s.topology,
        "awareness": s.awareness,
        "agents": s.agents,
        "byzantine": s.byzantine,
        "max_rounds": s.max_rounds,
    }
    if s.drop_prob:
        params["drop_prob"] = s.drop_prob
    if s.model:
        params["model"] = s.model
    return params


def scripted_fake_policy(strategy_name: str) -> str:
    """The role-aware FakeEngine policy mirroring ``strategy_name``:
    honest rows play the consensus policy, byzantine rows the
    strategy's scripted mirror."""
    return f"mixed:consensus:{get_strategy(strategy_name).fake_policy}"


def apply_scenario(config, name: str):
    """Overlay a registry entry onto a ``BCGConfig`` (the
    ``BCG_TPU_SCENARIO`` path — single-run entry points).

    Returns a new frozen config: game shape/strategy/awareness,
    topology, channel, and — on the fake backend — the strategy's
    scripted policy mirror.  Engine identity fields (real model,
    backend) are otherwise left to the caller's config.
    """
    import dataclasses

    s = get_scenario(name)
    game = dataclasses.replace(
        config.game,
        num_honest=s.agents - s.byzantine,
        num_byzantine=s.byzantine,
        byzantine_strategy=s.strategy,
        byzantine_awareness=s.awareness,
        max_rounds=s.max_rounds,
    )
    network = dataclasses.replace(config.network, topology_type=s.topology)
    comm = config.communication
    if s.drop_prob:
        comm = dataclasses.replace(
            comm, protocol_type="lossy_sim", drop_prob=s.drop_prob
        )
    engine = config.engine
    if engine.backend == "fake":
        engine = dataclasses.replace(
            engine, fake_policy=scripted_fake_policy(s.strategy)
        )
    if s.model:
        engine = dataclasses.replace(engine, model_name=s.model)
    return dataclasses.replace(
        config, game=game, network=network, communication=comm,
        engine=engine,
    )
