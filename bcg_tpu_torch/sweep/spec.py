"""Sweep specs: named game-config axes expanded into a deterministic
job list with stable job ids.

Every paper in PAPERS.md runs the same workload shape — hundreds of
game configs x seeds ("Byzantine-Robust Decentralized Coordination of
LLM Agents" sweeps agents/byzantine-fraction/topology grids) — yet the
repo could only launch one config per process.  A :class:`SweepSpec`
makes the grid a VALUE: a ``base`` mapping of defaults plus ``axes``
(parameter name -> list of values) expanded as a cross product in
sorted-axis-name order, so the job list (and every job's id) is a pure
function of the spec — two hosts expanding the same spec agree on the
exact job set and partition it by index with no coordination.

Job ids are content hashes of the job's resolved parameters (stable
across processes, axis reordering, and spec-file reformatting), which
makes the sweep manifest's checkpoint/resume bookkeeping mechanical:
"job ``j3f9c2a41d`` completed" means the same game everywhere.

A spec is either a named preset (:data:`PRESETS`) or a JSON file::

    {
      "name": "byzantine-grid",
      "base": {"backend": "fake", "max_rounds": 6},
      "axes": {
        "agents": [4, 6, 8],
        "byzantine": [0, 1],
        "topology": ["fully_connected", "ring"],
        "seed": [0, 1, 2]
      }
    }

No jax import — spec expansion must be loadable by flag-only consumers
(the CLI expands before any backend boots).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Dict, List, Mapping, Optional

# Import-light like this module (no jax, no config): the scenario
# registry feeds the ``scenario`` job key and the adversary-grid preset.
from bcg_tpu_torch.scenarios.registry import (
    scenario_names,
    scenario_params,
    scripted_fake_policy,
)

# Every parameter a job may carry, with its default.  A closed set:
# an unknown key in a spec is a hard error at EXPANSION time (a typo'd
# axis silently defaulting would sweep the wrong grid and only show up
# in the aggregate numbers).
JOB_DEFAULTS: Dict[str, Any] = {
    "agents": 5,
    "byzantine": 1,
    "topology": "fully_connected",
    "awareness": "may_exist",
    "seed": 0,
    "max_rounds": 8,
    "backend": "fake",
    "model": None,              # None = the backend's default model
    "fake_policy": None,        # engine/fake.py policy (fake backend)
    "scenario": None,           # scenarios/registry.py entry: overlays
                                # strategy/topology/channel/awareness/
                                # agent split (explicit keys still win)
    "strategy": None,           # scenarios/strategies.py adversary
    "drop_prob": None,          # lossy channel (comm/lossy_sim.py)
    "spmd_exchange": False,     # broadcast/receive as one all_gather
    "max_model_len": None,      # EngineConfig override (jax backend)
    "data_parallel_size": None,
    "decide_tokens": None,      # LLMConfig.max_tokens_decide override
    "vote_tokens": None,        # LLMConfig.max_tokens_vote override
    "priority": 0,              # tenant priority class (scheduler)
    "weight": 1.0,              # tenant fair-share weight
}


def _effective_fake_policy(p: Mapping[str, Any]) -> Optional[Any]:
    """The FakeEngine policy a job ACTUALLY runs: an explicit
    ``fake_policy`` wins; otherwise a ``strategy`` on the fake backend
    derives the role-aware scripted mirror (honest rows play consensus,
    byzantine rows the strategy's policy).  Used by both ``to_config``
    and ``engine_key`` — two jobs whose derived policies differ must
    never share one engine."""
    if p["fake_policy"] or p["backend"] != "fake" or not p["strategy"]:
        return p["fake_policy"]
    return scripted_fake_policy(str(p["strategy"]))


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One resolved game config of a sweep: a stable id plus the full
    parameter mapping (every :data:`JOB_DEFAULTS` key present)."""

    job_id: str
    params: Mapping[str, Any]

    def to_config(self):
        """The job's :class:`~bcg_tpu_torch.config.BCGConfig` (results sinks
        off — the sweep's own manifest/event files are the artifacts)."""
        from bcg_tpu_torch.config import (
            BCGConfig, resolve_model_name,
        )

        p = self.params
        base = BCGConfig()
        agents = int(p["agents"])
        byz = int(p["byzantine"])
        if byz >= agents:
            raise ValueError(
                f"job {self.job_id}: byzantine={byz} >= agents={agents}"
            )
        engine_kw: Dict[str, Any] = {"backend": p["backend"]}
        if p["model"]:
            engine_kw["model_name"] = resolve_model_name(str(p["model"]))
        fp = _effective_fake_policy(p)
        if fp:
            engine_kw["fake_policy"] = str(fp)
        if p["max_model_len"]:
            engine_kw["max_model_len"] = int(p["max_model_len"])
        if p["data_parallel_size"]:
            engine_kw["data_parallel_size"] = int(p["data_parallel_size"])
        llm_kw: Dict[str, Any] = {}
        if p["decide_tokens"]:
            llm_kw["max_tokens_decide"] = int(p["decide_tokens"])
        if p["vote_tokens"]:
            llm_kw["max_tokens_vote"] = int(p["vote_tokens"])
        comm = base.communication
        if p["drop_prob"]:
            comm = dataclasses.replace(
                comm,
                protocol_type="lossy_sim",
                drop_prob=float(p["drop_prob"]),
            )
        return dataclasses.replace(
            base,
            game=dataclasses.replace(
                base.game,
                num_honest=agents - byz,
                num_byzantine=byz,
                max_rounds=int(p["max_rounds"]),
                byzantine_awareness=str(p["awareness"]),
                byzantine_strategy=(
                    str(p["strategy"]) if p["strategy"] else None
                ),
                seed=int(p["seed"]),
            ),
            network=dataclasses.replace(
                base.network,
                topology_type=str(p["topology"]),
                spmd_exchange=bool(p["spmd_exchange"]),
            ),
            communication=comm,
            engine=dataclasses.replace(base.engine, **engine_kw),
            llm=dataclasses.replace(base.llm, **llm_kw),
            metrics=dataclasses.replace(
                base.metrics, save_results=False, generate_plots=False,
            ),
            verbose=False,
        )

    def engine_key(self) -> tuple:
        """Jobs sharing this key can share one engine + scheduler (the
        multi-tenant premise: one model boot serves the whole fleet).
        Keyed on the DERIVED fake policy, not the raw param — a
        strategy job and an explicit-policy job that resolve to
        different scripted behavior must boot separate engines."""
        p = self.params
        return (p["backend"], p["model"], p["max_model_len"],
                p["data_parallel_size"], _effective_fake_policy(p))


def job_id_for(params: Mapping[str, Any]) -> str:
    """Stable content id: ``j`` + 10 hex of the sha1 over the job's
    canonical JSON.  Depends only on resolved parameter VALUES — not on
    axis order, spec formatting, or expansion position — so resumed and
    cross-host expansions of one spec name the same jobs."""
    canon = json.dumps(
        {k: params[k] for k in sorted(params)}, sort_keys=True,
        separators=(",", ":"),
    )
    return "j" + hashlib.sha1(canon.encode()).hexdigest()[:10]


def expand(spec: Mapping[str, Any]) -> List[JobSpec]:
    """Deterministic job list: base defaults + every axis combination,
    axes iterated in sorted name order, values in declared order.
    Duplicate resolved configs (two combinations hashing identically)
    are a spec error — a sweep must never run one game twice under two
    positions."""
    base = dict(JOB_DEFAULTS)
    unknown = set(spec.get("base", {})) - set(JOB_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown base parameter(s) {sorted(unknown)}; known: "
            f"{sorted(JOB_DEFAULTS)}"
        )
    base.update(spec.get("base", {}))
    axes = dict(spec.get("axes", {}))
    unknown = set(axes) - set(JOB_DEFAULTS)
    if unknown:
        raise ValueError(
            f"unknown axis parameter(s) {sorted(unknown)}; known: "
            f"{sorted(JOB_DEFAULTS)}"
        )
    for name, values in axes.items():
        if not isinstance(values, (list, tuple)) or not values:
            raise ValueError(f"axis {name!r} must be a non-empty list")
    names = sorted(axes)
    # Scenario overlay precedence: JOB_DEFAULTS < registry entry <
    # explicitly-specified base/axis keys — a preset can pin e.g.
    # ``agents`` across every scenario without forking the registry.
    explicit = (set(spec.get("base", {})) | set(axes)) - {"scenario"}
    jobs: List[JobSpec] = []
    seen: Dict[str, Mapping[str, Any]] = {}
    for combo in itertools.product(*(axes[n] for n in names)):
        params = dict(base)
        params.update(zip(names, combo))
        if params.get("scenario"):
            # Unknown names fail the whole expansion loudly (KeyError
            # with the known list) — a typo'd scenario must never sweep
            # the default grid under a wrong label.
            for k, v in scenario_params(str(params["scenario"])).items():
                if k not in explicit:
                    params[k] = v
        jid = job_id_for(params)
        if jid in seen:
            raise ValueError(
                f"duplicate job {jid}: axis combination {dict(zip(names, combo))} "
                "resolves to a config already in the sweep"
            )
        seen[jid] = params
        jobs.append(JobSpec(job_id=jid, params=params))
    return jobs


def load_spec(source: str) -> Dict[str, Any]:
    """A spec mapping from a preset name or a JSON file path."""
    if source in PRESETS:
        return dict(PRESETS[source], name=source)
    with open(source) as f:
        spec = json.load(f)
    if not isinstance(spec, dict) or "axes" not in spec:
        raise ValueError(
            f"{source}: a sweep spec is a JSON object with an 'axes' "
            "mapping (and optional 'base'/'name')"
        )
    spec.setdefault("name", source)
    return spec


def spec_name(spec: Mapping[str, Any]) -> str:
    return str(spec.get("name", "sweep"))


# ----------------------------------------------------------------- presets
# Named grids for the workloads PAPERS.md actually runs.  All hermetic
# (fake backend) unless noted; the jax presets are the hardware arms.
PRESETS: Dict[str, Dict[str, Any]] = {
    # 4 jobs — CI smoke / quickstart.
    "smoke": {
        "base": {"agents": 4, "max_rounds": 4},
        "axes": {"byzantine": [0, 1], "seed": [0, 1]},
    },
    # 108 jobs — the acceptance-scale grid: mixed agent counts,
    # byzantine splits, topologies, and 9 seeds per cell (the
    # convergence-rate denominators the PAPERS.md methodology needs).
    "paper-grid": {
        "base": {"max_rounds": 6},
        "axes": {
            "agents": [4, 6, 8],
            "byzantine": [0, 1],
            "topology": ["fully_connected", "ring"],
            "seed": list(range(9)),
        },
    },
    # 21 jobs — the scenario-registry axis (ROADMAP item 2's sweep
    # surface): every named adversary experiment — strategy + topology
    # + channel + awareness bundle from bcg_tpu/scenarios — x 3 seeds.
    # Each job derives its role-aware FakeEngine policy from the
    # strategy (see _effective_fake_policy), so the grid runs scripted
    # mirrors hermetically and the same spec swaps to a real backend
    # with one base key.
    "adversary-grid": {
        "axes": {
            "scenario": list(scenario_names()),
            "seed": [0, 1, 2],
        },
    },
    # 3 jobs — the one-agent-per-chip scale ladder on the REAL engine
    # (scripts/scale_sweep.py wraps single rungs of this shape).
    "scale-ladder": {
        "base": {
            "backend": "jax", "model": "bcg-tpu/tiny-test",
            "max_model_len": 512, "max_rounds": 4, "spmd_exchange": True,
            "decide_tokens": 48, "vote_tokens": 32, "byzantine": 0,
        },
        "axes": {"agents": [8, 16, 32]},
    },
}
