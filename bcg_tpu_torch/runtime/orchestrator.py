"""Simulation orchestrator (reference ``main.py:67-995``).

Drives the five-phase lockstep round loop:

    Decide -> Broadcast -> Receive -> (summarize) -> Vote -> Advance

with batched LLM dispatch and a two-level failure ladder: batch retries up
to 3 attempts, dropping to per-agent sequential calls when <=30% of agents
failed (reference main.py:269-341), and terminal failures degrading to
abstain (decide) / CONTINUE (vote) — the game never crashes on bad LLM
output.

Differences from the reference (documented improvements):

* Config is an immutable :class:`BCGConfig`; nothing mutates globals.
* The engine is injected (fake for tests, JAX for TPU).
* Vote validity is role-aware: a Byzantine "abstain" answer is accepted
  directly instead of being rejected by the stop/continue-only check and
  re-generated up to 5 times (reference main.py:249-254 + 426-440).
* Message buffers are GC'd per round (the reference leaks them).
* Optional per-round checkpointing and phase profiling.

The port's copy of ``bcg_tpu/runtime/orchestrator.py``, trimmed to the
lockstep host-exchange path: the observability hooks (ROADMAP A12), the
SPMD exchange (A13) and the fused mega-round (A10) are not ported yet,
and configuring either of the latter two raises ``NotImplementedError``
instead of being ignored.  Game results do not depend on the hooks.
"""

from __future__ import annotations

import itertools
import os
import warnings
from typing import Dict, List, Optional, Tuple

from bcg_tpu_torch.agents import create_agent
from bcg_tpu_torch.comm import (
    AgentNetwork,
    Decision,
    DecisionType,
    NetworkTopology,
    Phase,
    create_protocol,
)
from bcg_tpu_torch.config import BCGConfig
from bcg_tpu_torch.engine.interface import InferenceEngine, create_engine
from bcg_tpu_torch.game import ByzantineConsensusGame
from bcg_tpu_torch.runtime import envflags
from bcg_tpu_torch.runtime.logging import RunLogger
from bcg_tpu_torch.scenarios.strategies import equivocation_value
from bcg_tpu_torch.runtime.metrics import build_metrics_payload, save_json_results, save_metrics_csv
from bcg_tpu_torch.runtime.profiler import SimulationProfiler

MAX_RETRIES = 3  # orchestrator-level batch attempts (main.py:269)
BATCH_RETRY_THRESHOLD = 0.3  # sequential fallback cutoff (main.py:270)
ROUND_SUMMARY_HISTORY = 15  # orchestrator pushes with this cap (main.py:515)
SUMMARY_REASONING_CHARS = 50  # per-agent reasoning snippet (main.py:493-495)


def build_topology(num_agents: int, network_config) -> NetworkTopology:
    """Topology dispatch — includes ``grid``, which the reference lists in
    config but never routes (main.py:140-147)."""
    t = network_config.topology_type
    if t == "fully_connected":
        return NetworkTopology.fully_connected(num_agents)
    if t == "ring":
        return NetworkTopology.ring(num_agents)
    if t == "grid":
        if network_config.grid_shape:
            rows, cols = network_config.grid_shape
        else:
            rows = max(1, int(num_agents**0.5))
            cols = -(-num_agents // rows)
        topo = NetworkTopology.grid(rows, cols)
        if topo.num_agents != num_agents:
            raise ValueError(
                f"grid {rows}x{cols} has {topo.num_agents} nodes, need {num_agents}"
            )
        return topo
    if t == "custom":
        return NetworkTopology.custom(network_config.custom_adjacency)
    return NetworkTopology.fully_connected(num_agents)


class BCGSimulation:
    """Wires game + network + agents + engine and runs the round loop."""

    # Process-unique sim ids: run numbering is derived from saved result
    # files, so with save_results=False EVERY sim is run "001" — the
    # uid keeps concurrent games' periodic checkpoints from clobbering
    # one file (see run_round).
    _uid_counter = itertools.count(1)

    def __init__(
        self,
        config: Optional[BCGConfig] = None,
        engine: Optional[InferenceEngine] = None,
        run_number: Optional[str] = None,
        log_mode: str = "w",
        sweep_job_id: Optional[str] = None,
    ):
        self.config = config or BCGConfig()
        # Scenario-registry overlay (BCG_TPU_SCENARIO): route any
        # single-run construction through the named registry entry —
        # strategy + topology + channel + awareness + agent split
        # (scenarios/registry.apply_scenario).  The sweep tier expands
        # scenarios at the spec layer instead, so it never sets this.
        scenario_name = envflags.get_str("BCG_TPU_SCENARIO")
        if scenario_name:
            from bcg_tpu_torch.scenarios import apply_scenario

            self.config = apply_scenario(self.config, scenario_name)
        if self.config.network.spmd_exchange:
            raise NotImplementedError(
                "spmd_exchange: the SPMD value exchange is not ported yet "
                "(ROADMAP A13)"
            )
        if self.config.agent.megaround or envflags.get_bool("BCG_TPU_MEGAROUND"):
            raise NotImplementedError(
                "megaround: the fused on-device round is not ported yet "
                "(ROADMAP A10)"
            )
        # Resolved adversary strategy (scenarios/strategies.py), or None
        # for the reference's single disrupt persona.
        self._strategy = None
        if self.config.game.byzantine_strategy:
            from bcg_tpu_torch.scenarios import get_strategy

            self._strategy = get_strategy(self.config.game.byzantine_strategy)
        # Sweep-tier job identity (bcg_tpu/sweep): stamped into the
        # game-event stream's game_start/game_end records so sweep
        # resume and cross-host report merging can account games by
        # JOB, not by per-process game ids.  None outside a sweep.
        self.sweep_job_id = sweep_job_id
        game_cfg = self.config.game
        metrics_cfg = self.config.metrics

        # Run numbering: next index after existing results/json/run_NNN.json
        # (reference main.py:95-110).  ``run_number`` is supplied when
        # resuming so artifacts stay under the original run id.
        json_dir = os.path.join(metrics_cfg.results_dir, "json")
        self.run_number = run_number or self._next_run_number(json_dir)
        self._sim_uid = next(BCGSimulation._uid_counter)

        log_path = None
        if metrics_cfg.save_results:
            log_path = os.path.join(
                metrics_cfg.results_dir, "logs", f"run_{self.run_number}_log.txt"
            )
        self.logger = RunLogger(log_path, verbose=self.config.verbose, mode=log_mode)
        if log_path:
            self.logger.echo(f"Starting run {self.run_number} - Logging to: {log_path}")

        self.game = ByzantineConsensusGame(
            num_honest=game_cfg.num_honest,
            num_byzantine=game_cfg.num_byzantine,
            value_range=game_cfg.value_range,
            consensus_threshold=game_cfg.consensus_threshold,
            max_rounds=game_cfg.max_rounds,
            seed=game_cfg.seed,
        )

        num_agents = game_cfg.num_honest + game_cfg.num_byzantine
        self.topology = build_topology(num_agents, self.config.network)
        comm_cfg = self.config.communication
        protocol = create_protocol(
            comm_cfg.protocol_type,
            num_agents=num_agents,
            topology=self.topology.adjacency_list,
            config={
                "drop_prob": comm_cfg.drop_prob,
                "delay_prob": comm_cfg.delay_prob,
                "max_delay_rounds": comm_cfg.max_delay_rounds,
                # None = unseeded: fresh channel-fault realizations per
                # run, mirroring the game's own unseeded behavior.
                "seed": game_cfg.seed,
            },
        )
        self.network = AgentNetwork(self.topology, protocol=protocol)

        self.engine = engine if engine is not None else create_engine(self.config.engine)
        self.profiler = SimulationProfiler()
        # Vote-phase shared-core prompt caching is only sound when every
        # agent provably received every broadcast — fully-connected
        # topology over the reliable channel (the SPMD exchange also
        # qualifies: it requires a2a_sim and delivers the full mask).
        # Ring/grid/custom topologies or a lossy channel give agents
        # DIFFERENT inboxes, so each keeps its per-agent prompt.
        # Opt-in (AgentConfig.shared_core_votes): the restructured prompt
        # diverges from the reference's vote format, so the default path
        # keeps reference-shaped prompts (advisor round-2 finding).
        self._vote_shared_core = (
            self.config.agent.shared_core_votes
            and self.config.network.topology_type == "fully_connected"
            and self.config.communication.protocol_type == "a2a_sim"
        )

        self.agents: Dict = {}
        self._plotted = False
        self._create_agents()

    @staticmethod
    def _next_run_number(json_dir: str) -> str:
        nums = []
        if os.path.isdir(json_dir):
            for f in os.listdir(json_dir):
                if f.startswith("run_") and f.endswith(".json"):
                    try:
                        nums.append(int(f[4:-5]))
                    except ValueError:
                        continue
        return f"{(max(nums) + 1 if nums else 1):03d}"

    def _create_agents(self) -> None:
        """One agent per game slot, all sharing the injected engine
        (reference main.py:176-230)."""
        self.logger.log("=" * 60)
        self.logger.log("Creating agents...")
        self.logger.log(f"Model: {self.config.engine.model_name}")
        self.logger.log(f"Backend: {self.config.engine.backend}")
        self.logger.log(f"Byzantine awareness: {self.config.game.byzantine_awareness}")
        self.logger.log("=" * 60)

        for idx, agent_id in enumerate(sorted(self.game.agents.keys())):
            game_agent = self.game.agents[agent_id]
            agent = create_agent(
                agent_id=agent_id,
                is_byzantine=game_agent.is_byzantine,
                engine=self.engine,
                value_range=self.config.game.value_range,
                byzantine_awareness=self.config.game.byzantine_awareness,
                llm_config=self.config.llm,
                strategy=self.config.game.byzantine_strategy,
                strategy_seed=self.config.game.seed,
            )
            if game_agent.initial_value is not None:
                agent.set_initial_value(game_agent.initial_value)
            self.network.register_agent(agent_id, agent, idx)
            self.agents[agent_id] = agent
        self.logger.log(f"All agents created! Total: {len(self.agents)}")

    def _equivocation_active(self) -> bool:
        """True when the resolved adversary strategy splits its proposal
        per receiver (scenarios/strategies.py ``equivocates``)."""
        return self._strategy is not None and self._strategy.equivocates

    # --------------------------------------------------------------- validity

    @staticmethod
    def _is_valid_decision_response(result: Optional[Dict]) -> bool:
        """Meaningful-content predicate (reference main.py:232-247): value
        present, strategy >=3 chars, reasoning >=10 chars."""
        if result is None or "error" in result:
            return False
        value = result.get("value")
        internal = result.get("internal_strategy", "")
        reasoning = result.get("public_reasoning", "")
        if not isinstance(value, int) or isinstance(value, bool):
            return False
        if not isinstance(internal, str) or len(internal.strip()) < 3:
            return False
        if not isinstance(reasoning, str) or len(reasoning.strip()) < 10:
            return False
        return True

    @staticmethod
    def _is_valid_byzantine_decision_response(result: Optional[Dict]) -> bool:
        """Byzantine variant: ``value`` may be the string "abstain" and
        ``public_reasoning`` is optional when abstaining (schema parity with
        bcg_agents.py:1083-1092; the reference's shared validity check would
        reject a legitimate abstain and burn retries on it)."""
        if result is None or "error" in result:
            return False
        value = result.get("value")
        internal = result.get("internal_strategy", "")
        if not isinstance(internal, str) or len(internal.strip()) < 3:
            return False
        return isinstance(value, int) or value == "abstain"

    @staticmethod
    def _is_valid_vote_response(agent, result: Optional[Dict]) -> bool:
        """Role-aware vote validity: accepted iff the decision is in the
        agent's own schema enum (delegates to the agent's predicate so the
        batched and sequential paths can't diverge)."""
        if result is None or "error" in result:
            return False
        return agent._validate_vote(result)

    # --------------------------------------------------------- batched phases

    def _run_batched_decisions(self, round_num: int, game_state: Dict) -> None:
        """All agents' decisions in one guided batch, with the retry ladder
        (reference main.py:256-374)."""
        agent_prompts: List[Tuple[str, Tuple]] = [
            (aid, agent.build_decision_prompt(game_state))
            for aid, agent in self.agents.items()
        ]
        if not agent_prompts:
            return

        agent_results: Dict[str, Optional[Dict]] = {aid: None for aid, _ in agent_prompts}
        pending = list(agent_prompts)

        def valid(aid, result):
            if self.agents[aid].is_byzantine:
                return self._is_valid_byzantine_decision_response(result)
            return self._is_valid_decision_response(result)

        # Retries resubmit the FULL batch and harvest only the pending
        # rows: decode is weight-bandwidth-bound, so a 3-row retry costs
        # the same device time as the full batch — but the full batch
        # reuses the already-compiled (B, L) decode loop, while a
        # subset-shaped batch would pay a fresh tens-of-seconds remote
        # compile (the reference re-batches only failures,
        # main.py:293-341; on TPU static shapes win).
        row_of = {aid: i for i, (aid, _) in enumerate(agent_prompts)}
        for attempt in range(1, MAX_RETRIES + 1):
            if not pending:
                break
            if attempt == 1:
                self.logger.log(
                    f"  [BATCHED] Processing {len(pending)} agents in single LLM call..."
                )
            else:
                self.logger.log(
                    f"  [RETRY {attempt}/{MAX_RETRIES}] Harvesting {len(pending)} "
                    f"pending rows from full batch of {len(agent_prompts)}..."
                )
            results = self.engine.batch_generate_json(
                [p for _, p in agent_prompts],
                temperature=self.config.llm.temperature_decide,
                max_tokens=self.config.llm.max_tokens_decide,
            )
            still_failed = []
            for aid, prompt_tuple in pending:
                result = results[row_of[aid]]
                if valid(aid, result):
                    agent_results[aid] = result
                else:
                    still_failed.append((aid, prompt_tuple))
                    self.logger.log(f"  [{aid}] Invalid response on attempt {attempt}")
            pending = still_failed

            if pending and attempt < MAX_RETRIES:
                if len(pending) / len(agent_prompts) <= BATCH_RETRY_THRESHOLD:
                    self.logger.log(
                        f"  [SEQUENTIAL RETRY] {len(pending)} agents failed, retrying individually..."
                    )
                    succeeded = []
                    for aid, _ in pending:
                        agent = self.agents[aid]
                        new_value = agent.decide_next_value(game_state)
                        # None is success too when it's a legitimate abstain
                        # (Byzantine "abstain"), not a retry exhaustion.
                        if new_value is not None or not agent.last_decision_failed:
                            agent_results[aid] = {"_sequential_success": True, "value": new_value}
                            succeeded.append(aid)
                    pending = [(a, p) for a, p in pending if a not in succeeded]
                    break  # sequential path already retried internally

        if pending:
            self.logger.log(
                f"  {len(pending)} agents failed all {MAX_RETRIES} attempts - they will abstain"
            )

        # Parse and commit proposals.  Decision outcome taxonomy for the
        # game-event stream: "valid" = batched response accepted (a None
        # value here is a legitimate Byzantine abstain, not a failure),
        # "fallback" = the sequential-retry ladder rescued it,
        # "invalid" = every attempt failed -> forced abstain.
        for aid, _ in agent_prompts:
            agent = self.agents[aid]
            result = agent_results.get(aid)
            if result is None:
                agent.last_reasoning = f"All {MAX_RETRIES} attempts failed - abstaining"
                self.logger.log(f"  {aid}: ABSTAINING (all attempts failed)")
                continue
            if result.get("_sequential_success"):
                new_value = result.get("value")
            else:
                new_value = agent.parse_decision_response(result, game_state)
            if new_value is None:
                self.logger.log(f"  {aid}: ABSTAINING")
                self.logger.log(f"    Reasoning: {agent.last_reasoning}")
                continue
            new_value = int(round(new_value))
            self.game.update_agent_proposal(aid, new_value)
            old = f"{int(agent.my_value)}" if agent.my_value is not None else "(no value yet)"
            self.logger.log(f"  {aid}: {old} -> {new_value}")
            self.logger.log(f"    Reasoning: {agent.last_reasoning}")

    def _run_batched_votes(self, game_state: Dict) -> Dict[str, Optional[bool]]:
        """All agents' termination votes in one guided batch
        (reference main.py:376-478)."""
        vote_prompts = [
            (aid, agent.build_vote_prompt(game_state))
            for aid, agent in self.agents.items()
        ]
        agent_results: Dict[str, Optional[Dict]] = {aid: None for aid, _ in vote_prompts}
        pending = list(vote_prompts)

        # Full-batch retries for shape reuse — see _run_batched_decisions.
        row_of = {aid: i for i, (aid, _) in enumerate(vote_prompts)}
        for attempt in range(1, MAX_RETRIES + 1):
            if not pending:
                break
            if attempt == 1:
                self.logger.log(
                    f"  [BATCHED] Processing {len(pending)} votes in single LLM call..."
                )
            else:
                self.logger.log(
                    f"  [RETRY {attempt}/{MAX_RETRIES}] Harvesting {len(pending)} "
                    f"pending votes from full batch of {len(vote_prompts)}..."
                )
            results = self.engine.batch_generate_json(
                [p for _, p in vote_prompts],
                temperature=self.config.llm.temperature_vote,
                max_tokens=self.config.llm.max_tokens_vote,
            )
            still_failed = []
            for aid, prompt_tuple in pending:
                result = results[row_of[aid]]
                if self._is_valid_vote_response(self.agents[aid], result):
                    agent_results[aid] = result
                else:
                    still_failed.append((aid, prompt_tuple))
                    self.logger.log(f"  [{aid}] Invalid vote on attempt {attempt}")
            pending = still_failed

            if pending and attempt < MAX_RETRIES:
                if len(pending) / len(vote_prompts) <= BATCH_RETRY_THRESHOLD:
                    self.logger.log(
                        f"  [SEQUENTIAL RETRY] {len(pending)} votes failed, retrying individually..."
                    )
                    for aid, _ in pending:
                        vote = self.agents[aid].vote_to_terminate(game_state)
                        agent_results[aid] = {"_sequential_success": True, "vote": vote}
                    pending = []
                    break

        if pending:
            self.logger.log(
                f"  {len(pending)} votes failed all attempts - defaulting to CONTINUE"
            )

        agent_votes: Dict[str, Optional[bool]] = {}
        for aid, _ in vote_prompts:
            agent = self.agents[aid]
            result = agent_results.get(aid)
            if result is None:
                vote: Optional[bool] = False
            elif result.get("_sequential_success"):
                vote = result.get("vote", False)
            else:
                vote = agent.parse_vote_response(result, game_state)
            agent_votes[aid] = vote
            label = "STOP" if vote is True else ("CONTINUE" if vote is False else "ABSTAIN")
            self.logger.log(f"  {aid}: votes {label}")
        return agent_votes

    # ----------------------------------------------------------- round pieces

    def _update_round_summaries(self, round_num: int) -> None:
        """Push one global compressed round summary into every agent's
        memory (reference main.py:480-515).  Format is load-bearing — the
        fake engine and agent history prompts both parse
        ``agent_i value: V | Reasoning: ...``."""
        parts = []
        for aid, agent in sorted(self.agents.items()):
            value = agent.my_value
            reasoning = agent.last_reasoning or ""
            if len(reasoning) > SUMMARY_REASONING_CHARS:
                reasoning = reasoning[: SUMMARY_REASONING_CHARS - 3] + "..."
            shown = f"{int(value)}" if value is not None else "ABSTAINED"
            part = f"{aid} value: {shown}"
            if reasoning:
                part += f" | Reasoning: {reasoning}"
            parts.append(part)
        summary = f"Round {round_num}: " + "; ".join(parts)
        for agent in self.agents.values():
            agent.memory.add_round_summary(summary, max_history=ROUND_SUMMARY_HISTORY)

    def set_engine(self, engine) -> None:
        """Swap the inference engine for this simulation AND its agents.

        Lets a caller route a simulation through a
        collective proxy engine (not ported yet, ROADMAP A11) for the
        duration of a lockstep wave (cross-game batching) and back —
        agents hold their own engine reference for the sequential-retry
        path, so both must move together.
        """
        self.engine = engine
        for agent in self.agents.values():
            agent.engine = engine

    # ------------------------------------------------------------- round loop

    def run_round(self) -> None:
        """One full consensus round (reference main.py:517-658)."""
        self._run_round()

    def _run_round(self) -> None:
        round_num = self.game.current_round
        self.logger.log("=" * 60)
        self.logger.log(f"Round {round_num}")
        self.logger.log("=" * 60)

        phase = Phase.PROPOSE
        game_state = self.game.get_game_state()
        game_state["vote_shared_core"] = self._vote_shared_core
        use_batched = (
            self.config.agent.use_batched_inference
            and self.config.agent.use_structured_output
        )

        # 1. Decide
        self.logger.log("[Decision Phase - LLM Reasoning]")
        with self.profiler.phase("decide"):
            if use_batched:
                self._run_batched_decisions(round_num, game_state)
            else:
                for aid, agent in self.agents.items():
                    new_value = agent.decide_next_value(game_state)
                    if new_value is None:
                        self.logger.log(f"  {aid}: ABSTAINING")
                        continue
                    self.game.update_agent_proposal(aid, int(round(new_value)))
                    self.logger.log(f"  {aid}: -> {int(round(new_value))}")

        # 2 + 3. Broadcast / Receive
        self.logger.log("[Broadcast Phase]")
        lo, hi = self.config.game.value_range
        equivocating = self._equivocation_active()
        with self.profiler.phase("broadcast"):
            for aid, agent in self.agents.items():
                proposed = self.game.agents[aid].proposed_value
                if proposed is None:
                    self.logger.log(f"  {aid}: (abstaining, no broadcast)")
                    continue
                reasoning = (
                    agent.last_reasoning
                    or f"Proposing value: {int(proposed)}"
                )
                if equivocating and agent.is_byzantine:
                    # Equivocation: one 'broadcast', receiver-addressed
                    # variants — each neighbour gets the deterministic
                    # per-receiver spread of the base proposal (the
                    # same arithmetic the SPMD and fused exchanges
                    # apply), under ONE timestamp so inbox ordering and
                    # message accounting match the honest broadcast.
                    sender_idx = self.network.agent_id_to_index[aid]
                    decisions = {
                        nbr: Decision(
                            type=DecisionType.VALUE.value,
                            value=int(
                                equivocation_value(
                                    int(proposed), nbr, lo, hi
                                )
                            ),
                        )
                        for nbr in self.topology.adjacency_list[sender_idx]
                    }
                    self.network.send_per_receiver(
                        aid, round_num, phase, decisions, reasoning
                    )
                    self.logger.log(
                        f"  {aid} (Byzantine): equivocates around value "
                        f"{int(proposed)}"
                    )
                    continue
                self.network.broadcast_message(
                    sender_id=aid,
                    round_num=round_num,
                    phase=phase,
                    decision=Decision(type=DecisionType.VALUE.value, value=int(proposed)),
                    reasoning=reasoning,
                )
                tag = " (Byzantine)" if agent.is_byzantine else ""
                self.logger.log(f"  {aid}{tag}: broadcasts value {int(proposed)}")

        self.logger.log("[Receive Phase - Updating State]")
        with self.profiler.phase("receive"):
            for aid, agent in self.agents.items():
                messages = self.network.get_messages(aid, round_num, phase)
                proposals = [
                    (
                        self.network.index_to_agent_id[m.sender_id],
                        m.decision.value,
                        m.reasoning,
                    )
                    for m in messages
                ]
                agent.receive_proposals(proposals)
                agent.my_value = self.game.agents[aid].proposed_value
                self.logger.log(f"  {aid}: received {len(proposals)} proposals, updated state")

        # 3.5 Round summaries + Q3 reasoning capture
        self._update_round_summaries(round_num)
        self.game.store_round_reasoning(
            {
                aid: agent.last_reasoning
                for aid, agent in self.agents.items()
                if agent.last_reasoning
            }
        )

        # 4. Vote
        self.logger.log("[Voting Phase]")
        with self.profiler.phase("vote"):
            if use_batched:
                agent_votes = self._run_batched_votes(game_state)
            else:
                agent_votes = {}
                for aid, agent in self.agents.items():
                    vote = agent.vote_to_terminate(game_state)
                    agent_votes[aid] = vote

        self._advance_and_record(round_num, agent_votes)

    def _advance_and_record(
        self, round_num: int, agent_votes: Dict[str, Optional[bool]]
    ) -> None:
        """Round tail shared by the lockstep and mega-round paths: vote
        events, game/network advance, per-round bookkeeping, checkpoints.
        """
        vote_info = self.game.get_all_termination_votes(agent_votes)
        self.logger.log(
            f"  All agents voting to stop: {vote_info['total_stop_votes']}/{vote_info['total_agents']}"
        )

        # 5. Advance
        self.game.advance_round(agent_votes)
        self.network.advance_round()
        self.network.end_round_gc(round_num)
        self.profiler.count_round(num_decisions=2 * len(self.agents))

        # Per-round checkpoints (--checkpoint-every-round) ride the
        # save_results sinks; BCG_TPU_SERVE_CHECKPOINT_EVERY=N
        # additionally checkpoints every N rounds regardless of the
        # result sinks — long serving sweeps (bcg_tpu/serve) survive the
        # short healthy hardware windows without paying a file write per
        # round per game.
        checkpoint_n = envflags.get_int("BCG_TPU_SERVE_CHECKPOINT_EVERY")
        if (
            (self.config.metrics.checkpoint_every_round
             and self.config.metrics.save_results)
            or (checkpoint_n > 0 and round_num % checkpoint_n == 0)
        ):
            from bcg_tpu_torch.runtime.checkpoint import save_checkpoint

            # With result sinks OFF, run numbering is not unique (every
            # sim scans an empty json/ dir and becomes "001") — suffix
            # the process-unique sim uid so G concurrent games write G
            # checkpoints instead of clobbering one file.
            name = (
                f"run_{self.run_number}.json"
                if self.config.metrics.save_results
                else f"run_{self.run_number}_g{self._sim_uid}.json"
            )
            save_checkpoint(self, os.path.join(
                self.config.metrics.results_dir, "checkpoints", name,
            ))

        last = self.game.rounds[-1]
        self.logger.log(f"[Round {round_num} Summary]")
        self.logger.log(f"  Most common value: {last.consensus_value}")
        self.logger.log(f"  Consensus reached: {last.has_consensus}")

    def run(self) -> Dict:
        """Full simulation (reference main.py:660-691).  Returns stats."""
        self.logger.log("BYZANTINE CONSENSUS GAME - Simulation Started")
        self.logger.log(
            f"  Agents: {self.game.num_honest} honest + {self.game.num_byzantine} Byzantine (hidden)"
        )
        self.logger.log(f"  Max rounds: {self.game.max_rounds}")
        for aid, st in self.game.agents.items():
            shown = int(st.initial_value) if st.initial_value is not None else "(no initial value)"
            self.logger.log(f"  {aid}: {shown}")

        while not self.game.game_over:
            self.run_round()

        self.display_results()
        if self.config.metrics.save_results:
            self.save_results()
        else:
            self._maybe_plot()  # --plots without result files still plots
        return self.game.get_statistics()

    # ----------------------------------------------------------------- output

    def display_results(self) -> None:
        """Final results display (reference main.py:693-790).

        Always printed to the console — the reference emits this block via
        ``tee_print`` (main.py:792-850), so it is visible without --verbose.
        """
        stats = self.game.get_statistics()
        log = self.logger.echo
        log("=" * 60)
        log("SIMULATION COMPLETE")
        log("=" * 60)
        log(f"  Total rounds: {stats['total_rounds']} / {stats['max_rounds']}")
        log(f"  Consensus reached: {stats['consensus_reached']}")
        if stats["honest_agents_won"] is True:
            log("  HONEST AGENTS WON - Consensus reached!")
        elif stats["honest_agents_won"] is False:
            log("  HONEST AGENTS LOST - No consensus achieved")
        if stats["consensus_reached"]:
            log(f"  Consensus value: {int(stats['consensus_value'])}")
            log(f"  Agreement rate: {stats['agreement_rate']:.1f}% of honest agents")
            log(f"  Quality score: {stats['consensus_quality_score']:.0f}/100")
            if stats["byzantine_infiltration"] is not None:
                log(f"  Byzantine infiltration: {stats['byzantine_infiltration']:.1f}%")
        log("[Final Values]")
        for aid, st in self.game.agents.items():
            initial = int(st.initial_value) if st.initial_value is not None else "(none)"
            final = int(st.current_value) if st.current_value is not None else "(none)"
            tag = " [BYZANTINE]" if st.is_byzantine else ""
            log(f"  {aid}: {initial} -> {final}{tag}")
        log("[Byzantine Agents Revealed]")
        log(f"  Byzantine: {', '.join(stats['byzantine_agent_ids']) or '(none)'}")
        log(f"  Honest: {', '.join(stats['honest_agent_ids'])}")
        net = self.network.get_network_stats()
        log("[Communication Statistics]")
        log(f"  Total messages: {net['total_messages']}")
        log(f"  Topology: {net['topology_type']} (avg degree {net['avg_degree']:.1f})")
        perf = self.profiler.summary()
        log("[Performance]")
        log(f"  Wall-clock: {perf['total_seconds']:.2f}s")
        log(f"  Rounds/sec: {perf['rounds_per_sec']:.3f}")
        log(f"  Agent-decisions/sec: {perf['decisions_per_sec']:.3f}")

    def save_results(self) -> str:
        """Persist the three sinks: JSON, CSV metrics, log (reference
        main.py:792-995; layout byte-compatible)."""
        stats = self.game.get_statistics()
        message_count = self.network.protocol.get_total_message_count()
        metrics = build_metrics_payload(
            run_number=int(self.run_number),
            stats=stats,
            config=self.config,
            message_count=message_count,
            profile=self.profiler.summary(),
        )
        json_path = save_json_results(
            self.config.metrics.results_dir,
            self.run_number,
            config=self.config,
            stats=stats,
            metrics=metrics,
            game=self.game,
            message_count=message_count,
            network_stats=self.network.get_network_stats(),
        )
        csv_path = save_metrics_csv(
            self.config.metrics.results_dir, self.run_number, metrics
        )
        self.logger.log("[Results Saved]")
        self.logger.log(f"  JSON: {json_path}")
        self.logger.echo(f"Results: {json_path}")
        self.logger.echo(f"Metrics: {csv_path}")
        self._maybe_plot()
        return json_path

    def _maybe_plot(self) -> None:
        if not self.config.metrics.generate_plots or self._plotted:
            return
        self._plotted = True
        from bcg_tpu_torch.runtime.plots import generate_run_plots

        plot_path = generate_run_plots(
            self.game, self.config.metrics.results_dir, self.run_number
        )
        if plot_path:
            self.logger.echo(f"Plots: {plot_path}")
        else:
            self.logger.echo("Plots requested but not generated "
                             "(matplotlib unavailable or no rounds)")

    def close(self) -> None:
        self.logger.close()
