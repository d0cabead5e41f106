"""Base game agent (reference ``bcg_agents.py:134-337``).

Design change vs the reference: agents *compose* an injected
:class:`InferenceEngine` instead of inheriting from the engine class
(reference ``BCGAgent(VLLMAgent)``), so the same agent code runs against
the JAX engine on TPU or the fake engine in tests.

Truncation constants carried over exactly (SURVEY.md §5.7): public
reasoning 600 chars in agent state (bcg_agents.py:632), internal strategy
400 chars (:292), current-round reasoning shown at 200 chars in vote
prompts (:538-545), history window of 3 rounds in prompts (:445).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from bcg_tpu_torch.agents.state import AgentMemory
from bcg_tpu_torch.engine.interface import InferenceEngine

REASONING_STATE_LIMIT = 600
STRATEGY_LIMIT = 400
VOTE_REASONING_SNIPPET = 200
PROMPT_HISTORY_ROUNDS = 3


class BCGAgent:
    """Common machinery for honest and Byzantine agents."""

    def __init__(
        self,
        agent_id: str,
        is_byzantine: bool,
        engine: InferenceEngine,
        value_range: Tuple[int, int],
        byzantine_awareness: str = "may_exist",
        max_json_retries: int = 3,
        temperature_decide: float = 0.5,
        temperature_vote: float = 0.3,
        max_tokens_decide: int = 300,
        max_tokens_vote: int = 200,
        strategy: Optional[str] = None,
        strategy_seed: Optional[int] = None,
    ):
        self.agent_id = agent_id
        self.is_byzantine = is_byzantine
        self.engine = engine
        self.value_range = tuple(value_range)
        self.byzantine_awareness = byzantine_awareness
        # Adversary-library strategy (scenarios/strategies.py): shapes
        # the Byzantine prompt persona/task; honest agents ignore it.
        # strategy_seed feeds the clique's shared-target derivation.
        self.strategy = strategy
        self.strategy_seed = strategy_seed
        self.max_json_retries = max_json_retries
        self.temperature_decide = temperature_decide
        self.temperature_vote = temperature_vote
        self.max_tokens_decide = max_tokens_decide
        self.max_tokens_vote = max_tokens_vote

        self.initial_value: Optional[int] = None
        self.my_value: Optional[int] = None
        self.received_proposals: List[Tuple[str, int, str]] = []
        self.last_reasoning = ""
        self.a2a_client = None
        # True when the most recent decide_next_value exhausted all engine
        # retries (distinguishes terminal failure from a legitimate abstain,
        # which also returns None).
        self.last_decision_failed = False

        self.memory = AgentMemory()
        self.memory.current_goal = (
            "DISRUPT_CONSENSUS" if is_byzantine else "REACH_CONSENSUS"
        )

        self._cached_system_prompt: Optional[str] = None
        self._cached_vote_system_prompt: Optional[str] = None

    # ----------------------------------------------------------------- wiring

    def set_a2a_client(self, client) -> None:
        self.a2a_client = client

    def set_initial_value(self, value: int) -> None:
        self.initial_value = value
        self.my_value = value
        self._cached_system_prompt = None
        self._cached_vote_system_prompt = None

    def receive_proposals(self, proposals: List[Tuple[str, int, str]]) -> None:
        """Replace the inbox with this round's proposals and update
        neighbour stats (reference bcg_agents.py:190-194)."""
        self.received_proposals = proposals
        for sender_id, value, _reasoning in proposals:
            self.memory.update_neighbor_stat(sender_id, value)

    # ------------------------------------------------------------- formatting

    def _format_strategy_history(self) -> str:
        return "\n".join(
            f"round {r}: {note}" for r, note in self.memory.last_k_internal_strategies
        )

    def _format_recent_history(self, max_rounds: int = PROMPT_HISTORY_ROUNDS) -> str:
        """Last N round summaries, most recent first
        (reference bcg_agents.py:271-285)."""
        if not self.memory.last_k_rounds:
            return "(No history yet - this is round 1)"
        recent = self.memory.last_k_rounds[-max_rounds:]
        return "\n".join(reversed(recent))

    def _record_internal_strategy(self, round_num: int, strategy: str) -> None:
        if not strategy:
            return
        trimmed = strategy.strip()[:STRATEGY_LIMIT]
        if trimmed:
            self.memory.add_internal_strategy(round_num, trimmed)

    def _current_round_proposals_block(self) -> str:
        """Current round's proposals incl. the agent's own, used in vote
        prompts (reference bcg_agents.py:533-547)."""
        lines = []
        if self.my_value is not None:
            lines.append(f"  {self.agent_id} (you): {int(self.my_value)}")
            snippet = self.last_reasoning[:VOTE_REASONING_SNIPPET] if self.last_reasoning else "(no reasoning)"
            lines.append(f"    Reasoning: {snippet}")
        else:
            lines.append(f"  {self.agent_id} (you): ABSTAINED")
        for sender_id, value, reasoning in self.received_proposals:
            lines.append(f"  {sender_id}: {int(value)}")
            if reasoning:
                lines.append(f"    Reasoning: {reasoning[:VOTE_REASONING_SNIPPET]}")
        return "\n".join(lines)

    def _shared_proposals_block(self) -> str:
        """Global proposals view for vote-phase shared-core caching:
        byte-IDENTICAL across agents when every agent received every
        broadcast (fully-connected reliable delivery — the orchestrator
        gates the mode on exactly that).  Sorted by agent id, no "(you)"
        marker — identity lives in the per-agent prompt tail; abstaining
        agents broadcast nothing and appear nowhere."""
        entries = {
            sid: (int(value), reasoning)
            for sid, value, reasoning in self.received_proposals
        }
        if self.my_value is not None:
            # Mirror the orchestrator's broadcast fallback text exactly so
            # this agent's own line matches what every OTHER agent shows.
            own = self.last_reasoning or f"Proposing value: {int(self.my_value)}"
            entries[self.agent_id] = (int(self.my_value), own)
        lines = []
        for sid in sorted(entries):
            value, reasoning = entries[sid]
            lines.append(f"  {sid}: {value}")
            if reasoning:
                lines.append(f"    Reasoning: {reasoning[:VOTE_REASONING_SNIPPET]}")
        return "\n".join(lines) if lines else "  (no proposals this round)"

    def _vote_identity_block(self) -> str:
        """Per-agent tail companion of :meth:`_shared_proposals_block`:
        carries the identity and own-proposal status the shared core
        omits."""
        if self.my_value is not None:
            snippet = (
                self.last_reasoning or f"Proposing value: {int(self.my_value)}"
            )[:VOTE_REASONING_SNIPPET]
            return (
                f"You are {self.agent_id}. Your proposal this round: "
                f"{int(self.my_value)}\nYour reasoning: {snippet}"
            )
        return f"You are {self.agent_id}. You ABSTAINED this round"

    # ------------------------------------------------------ abstract surface

    def build_system_prompt(self, game_state: Dict) -> str:
        raise NotImplementedError

    def build_round_prompt(self, game_state: Dict) -> str:
        raise NotImplementedError

    def build_vote_system_prompt(self, game_state: Dict) -> str:
        raise NotImplementedError

    def build_vote_round_prompt(self, game_state: Dict) -> str:
        raise NotImplementedError

    def decision_schema(self) -> Dict[str, Any]:
        raise NotImplementedError

    def vote_schema(self) -> Dict[str, Any]:
        raise NotImplementedError

    def _validate_decision(self, result: Dict) -> bool:
        raise NotImplementedError

    def parse_decision_response(self, result: Dict, game_state: Dict) -> Optional[int]:
        raise NotImplementedError

    def parse_vote_response(self, result: Dict, game_state: Dict) -> Optional[bool]:
        raise NotImplementedError

    # ------------------------------------------------- batched-path builders

    def build_decision_prompt(self, game_state: Dict) -> Tuple[str, str, Dict]:
        """(system_prompt, round_prompt, schema) for batched inference
        (reference bcg_agents.py:577-601 / 1069-1094)."""
        return (
            self.build_system_prompt(game_state),
            self.build_round_prompt(game_state),
            self.decision_schema(),
        )

    def build_vote_prompt(self, game_state: Dict) -> Tuple[str, str, Dict]:
        return (
            self.build_vote_system_prompt(game_state),
            self.build_vote_round_prompt(game_state),
            self.vote_schema(),
        )

    # -------------------------------------------------------- sequential path

    def step(self, round_t: int, phase: str, game_state: Dict) -> Optional[int]:
        """Full per-round decision loop (documented contract at reference
        bcg_agents.py:226-253): inbox was delivered via
        :meth:`receive_proposals`; build prompts from memory, call the
        shared engine, parse, return the proposed value (None = abstain)."""
        return self.decide_next_value(game_state)

    def decide_next_value(self, game_state: Dict) -> Optional[int]:
        """Sequential decision with the per-agent retry ladder
        (reference bcg_agents.py:683-791): up to ``max_json_retries``
        engine calls, each failure appending a corrective instruction to
        the round prompt; total failure -> abstain."""
        round_prompt = self.build_round_prompt(game_state)
        result = self._generate_with_retries(
            system_prompt=self.build_system_prompt(game_state),
            round_prompt=round_prompt,
            schema=self.decision_schema(),
            validate=self._validate_decision,
            retry_suffix=self._decision_retry_suffix(),
            temperature=self.temperature_decide,
            max_tokens=self.max_tokens_decide,
        )
        if result is None:
            self.last_decision_failed = True
            self.last_reasoning = (
                f"JSON PARSING FAILED ({self.max_json_retries} attempts) - no response"
            )
            return None
        self.last_decision_failed = False
        return self.parse_decision_response(result, game_state)

    def vote_to_terminate(self, game_state: Dict) -> Optional[bool]:
        """Sequential vote with the same retry ladder
        (reference bcg_agents.py:793-876).  Total failure -> CONTINUE."""
        result = self._generate_with_retries(
            system_prompt=self.build_vote_system_prompt(game_state),
            round_prompt=self.build_vote_round_prompt(game_state),
            schema=self.vote_schema(),
            validate=self._validate_vote,
            retry_suffix=self._vote_retry_suffix(),
            temperature=self.temperature_vote,
            max_tokens=self.max_tokens_vote,
        )
        if result is None:
            return False
        return self.parse_vote_response(result, game_state)

    def _validate_vote(self, result: Dict) -> bool:
        decision = result.get("decision", "")
        allowed = self.vote_schema()["properties"]["decision"]["enum"]
        return isinstance(decision, str) and decision.strip() in allowed

    def _generate_with_retries(
        self,
        system_prompt: str,
        round_prompt: str,
        schema: Dict,
        validate,
        retry_suffix: str,
        temperature: float,
        max_tokens: int,
    ) -> Optional[Dict]:
        """Engine-level retry loop with corrective re-prompting.

        ``round_prompt`` may be a plain string or a ``(core, tail)`` pair
        (vote-phase shared-core caching); the corrective retry text
        appends to the TAIL so the cached core stays byte-identical."""
        prompt = round_prompt
        for attempt in range(1, self.max_json_retries + 1):
            result = self.engine.generate_json(
                prompt,
                schema,
                temperature=temperature,
                max_tokens=max_tokens,
                system_prompt=system_prompt,
            )
            if "error" not in result and validate(result):
                return result
            if attempt < self.max_json_retries:
                retry_text = (
                    f"\n\nRETRY ATTEMPT {attempt + 1}/{self.max_json_retries}:\n"
                    f"{retry_suffix}"
                )
                if isinstance(round_prompt, tuple):
                    prompt = (round_prompt[0], round_prompt[1] + retry_text)
                else:
                    prompt = round_prompt + retry_text
        return None

    def _decision_retry_suffix(self) -> str:
        return (
            "Your previous response was invalid or had empty fields. "
            "Output ONLY a valid JSON object with every required field "
            "filled in, and nothing outside the JSON."
        )

    def _vote_retry_suffix(self) -> str:
        options = " or ".join(
            f'{{"decision": "{o}"}}'
            for o in self.vote_schema()["properties"]["decision"]["enum"]
        )
        return (
            "Your previous response was invalid. "
            f"Output ONLY valid JSON: {options}. Nothing outside the JSON."
        )

    # ------------------------------------------------------------- checkpoint

    def snapshot(self) -> Dict:
        return {
            "agent_id": self.agent_id,
            "is_byzantine": self.is_byzantine,
            "initial_value": self.initial_value,
            "my_value": self.my_value,
            "received_proposals": [list(p) for p in self.received_proposals],
            "last_reasoning": self.last_reasoning,
            "memory": self.memory.snapshot(),
        }

    def restore(self, data: Dict) -> None:
        self.initial_value = data["initial_value"]
        self.my_value = data["my_value"]
        self.received_proposals = [tuple(p) for p in data["received_proposals"]]
        self.last_reasoning = data["last_reasoning"]
        self.memory = AgentMemory.from_snapshot(data["memory"])
