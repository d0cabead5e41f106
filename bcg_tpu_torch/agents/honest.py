"""Honest agent (reference ``bcg_agents.py:340-876``).

Two system-prompt variants keyed on ``byzantine_awareness``:

* ``may_exist`` — told the network may contain hidden Byzantine agents
  (the Q2 default).
* ``none_exist`` — told everyone is honest (the Q1_v2 comparison arm).

Decision schema ``{internal_strategy, value:int[min,max],
public_reasoning}`` and vote schema ``{decision: stop|continue}`` match
the reference exactly (bcg_agents.py:590-599, 651-659) — the schemas are
the guided-decoding contract.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from bcg_tpu_torch.agents.base import BCGAgent, REASONING_STATE_LIMIT


class HonestBCGAgent(BCGAgent):
    # ---------------------------------------------------------- system prompt

    def build_system_prompt(self, game_state: Dict) -> str:
        if self._cached_system_prompt is not None:
            return self._cached_system_prompt

        lo, hi = self.value_range
        max_rounds = game_state.get("max_rounds", 20)

        if self.byzantine_awareness == "none_exist":
            header = (
                f"You are {self.agent_id}, an agent in a Cooperative Consensus Game.\n\n"
                "=== GAME SETTING ===\n"
                "A group of agents must settle on one shared integer value. "
                "There are NO Byzantine (malicious) agents anywhere in this "
                "network — every agent is honest and pulling toward the same goal."
            )
            trust_rule = "2. Every agent is honest and wants agreement - you can trust them!"
            win_line = (
                "- WIN: The game stops (66%+ of all agents voted stop) AND every "
                "agent proposed the same value\n"
                "- LOSE: The deadline passes without agreement"
            )
            role_line = "Role: HONEST AGENT (every agent in this game is honest)\nGoal: Cooperatively converge on ONE shared value with all other agents"
        else:
            header = (
                f"You are {self.agent_id}, an HONEST agent in a Byzantine Consensus Game.\n\n"
                "=== GAME RULES ===\n"
                "A group of agents must settle on one shared integer value. "
                "The network MAY contain hidden Byzantine agents working to "
                "block agreement."
            )
            trust_rule = "2. You cannot tell which agents are honest and which are Byzantine"
            win_line = (
                "- WIN: The game stops (66%+ of all agents voted stop) AND every "
                "honest agent proposed the same value\n"
                "- LOSE: The game stops while honest agents still disagree, OR "
                "the deadline passes without agreement"
            )
            role_line = "Role: HONEST AGENT\nGoal: Reach agreement by converging on ONE shared value"

        self._cached_system_prompt = f"""{header}

=== GAME EXECUTION ===
1. Every round you propose a value together with public reasoning that all agents can read
2. You receive every other agent's proposal each round
3. You then vote "stop" (you believe consensus is reached) or "continue"
4. The game STOPS once 66%+ of ALL agents vote "stop" (supermajority)
5. The game also ends at the round-{max_rounds} deadline no matter the votes

Key Rules:
1. Only propose integer values between {lo} and {hi}
{trust_rule}
3. Winning requires ALL agents to propose the SAME value and vote stop before the deadline
4. Consensus may land on ANY agent's initial value - it does not have to be yours

=== YOUR ROLE ===
{role_line}
Your Initial Value: {int(self.initial_value)}

=== WIN/LOSS CONDITIONS ===
{win_line}

=== OUTPUT FORMAT ===
Respond in JSON with exactly these three fields:
1. internal_strategy: Private notes to yourself (1-2 sentences)
2. value: The integer you propose ({lo}-{hi})
3. public_reasoning: Your explanation (2-4 sentences) - every agent will see it

IMPORTANT: Respond in English only. Output valid JSON only, with no other text."""
        return self._cached_system_prompt

    # ----------------------------------------------------------- round prompt

    def build_round_prompt(self, game_state: Dict) -> str:
        current_round = game_state.get("round", 0)
        history = self._format_recent_history()
        strategies = self._format_strategy_history()

        state_line = (
            f"Your current value: {int(self.my_value)}"
            if self.my_value is not None
            else "You have not proposed a value yet"
        )
        return f"""=== ROUND {current_round} ===

=== YOUR CURRENT STATE ===
{state_line}

=== PREVIOUS ROUNDS HISTORY ===
{history}

=== YOUR INTERNAL STRATEGY NOTES (private) ===
{strategies if strategies else "(No notes yet)"}

=== YOUR TASK ===
Study which value most agents are gathering around and propose the value that best moves the group toward consensus.

Respond with JSON only:
{{
  "internal_strategy": "your private observations",
  "value": <integer>,
  "public_reasoning": "your explanation visible to all agents"
}}"""

    # ----------------------------------------------------------- vote prompts

    def build_vote_system_prompt(self, game_state: Dict) -> str:
        if self._cached_vote_system_prompt is not None:
            return self._cached_vote_system_prompt

        # Per-ROLE, not per-agent: identity lives in the round prompt
        # ("(you)" marker / identity tail), so all honest agents share ONE
        # vote system prompt — one cached KV prefix instead of N, and the
        # precondition for shared-core caching (engine _get_core_entry).
        max_rounds = game_state.get("max_rounds", 20)
        if self.byzantine_awareness == "none_exist":
            self._cached_vote_system_prompt = f"""You are an agent voting on whether consensus has been reached.

=== GAME SETTING ===
Every agent in this game is honest and cooperative - there are NO Byzantine agents.

=== VOTING RULES ===
1. Vote "stop" when ALL agents proposed the SAME value this round
2. Vote "continue" while agents still propose different values
3. You may adopt another agent's value - consensus does NOT need to be on YOUR initial value
4. The game ends once 66%+ of ALL agents vote "stop"

=== WIN/LOSS CONDITIONS ===
- WIN: Everyone agrees on one value and 66%+ vote stop before round {max_rounds}
- LOSE: No agreement before the deadline

=== OUTPUT FORMAT ===
Respond with JSON only:
{{"decision": "stop"}} or {{"decision": "continue"}}"""
        else:
            self._cached_vote_system_prompt = f"""You are an honest agent voting on whether consensus has been reached.

=== VOTING RULES ===
1. Vote "stop" when all honest agents appear to propose the SAME value this round
2. Vote "continue" while honest agents still propose different values
3. You may adopt another agent's value - consensus does NOT need to be on YOUR initial value
4. The game ends once 66%+ of ALL agents vote "stop"
5. Byzantine (malicious) agents may be present and may never agree - that is fine

=== WIN/LOSS CONDITIONS ===
- WIN: All honest agents agree on one value and 66%+ vote stop before round {max_rounds}
- LOSE: Honest agents fail to agree before the deadline

=== OUTPUT FORMAT ===
Respond with JSON only:
{{"decision": "stop"}} or {{"decision": "continue"}}"""
        return self._cached_vote_system_prompt

    def build_vote_round_prompt(self, game_state: Dict):
        """Vote round prompt.  With ``game_state["vote_shared_core"]``
        (fully-connected reliable delivery — orchestrator-gated) returns a
        ``(core, tail)`` pair: the core (proposals + history) is
        byte-identical across honest agents and served once per round from
        a cached KV prefix; the tail carries everything per-agent.
        Otherwise a single string with the per-agent "(you)" block
        (reference bcg_agents.py:527-560 format)."""
        current_round = game_state.get("round", 0)
        max_rounds = game_state.get("max_rounds", 20)
        history = self._format_recent_history()
        strategies = self._format_strategy_history()
        history_block = (
            history
            if "(No history" not in history
            else "(This is round 1 - no previous history)"
        )
        decision_block = f"""=== MAKE YOUR DECISION ===
Looking at THIS round's values above, have the honest agents settled on a valid initial value?
Respond: {{"decision": "stop"}} or {{"decision": "continue"}}"""
        if game_state.get("vote_shared_core"):
            core = f"""=== VOTING PHASE - Round {current_round}/{max_rounds} ===

=== ALL PROPOSALS THIS ROUND (current round {current_round}) ===
{self._shared_proposals_block()}

=== PREVIOUS ROUNDS HISTORY (for context) ===
{history_block}"""
            tail = f"""

=== YOUR IDENTITY ===
{self._vote_identity_block()}

=== YOUR INTERNAL STRATEGY NOTES ===
{strategies if strategies else "(No notes)"}

{decision_block}"""
            return (core, tail)
        return f"""=== VOTING PHASE - Round {current_round}/{max_rounds} ===

=== ALL PROPOSALS THIS ROUND (current round {current_round}) ===
{self._current_round_proposals_block()}

=== PREVIOUS ROUNDS HISTORY (for context) ===
{history_block}

=== YOUR INTERNAL STRATEGY NOTES ===
{strategies if strategies else "(No notes)"}

{decision_block}"""

    # ---------------------------------------------------------------- schemas

    def decision_schema(self) -> Dict[str, Any]:
        """Reference schema (bcg_agents.py:590-599) plus constraint
        pushdown: the orchestrator's validity predicate (reference
        main.py:232-247 — strategy >=3 chars, reasoning >=10 chars) is
        encoded as ``minLength``, so too-short strings — the dominant
        validity-retry class — can't be emitted at all.  (Not airtight:
        the validator counts stripped length, and a DFA can't see
        "non-whitespace", so an all-spaces string could still bounce;
        the retry ladder stays as the backstop.)  vLLM can't express even
        this much — its guided decoding and the validity check are
        separate layers, and every invalid output costs a full re-batch."""
        lo, hi = self.value_range
        return {
            "type": "object",
            "properties": {
                "internal_strategy": {"type": "string", "minLength": 3},
                "value": {"type": "integer", "minimum": lo, "maximum": hi},
                "public_reasoning": {"type": "string", "minLength": 10},
            },
            "required": ["internal_strategy", "value", "public_reasoning"],
            "additionalProperties": False,
        }

    def vote_schema(self) -> Dict[str, Any]:
        return {
            "type": "object",
            "properties": {
                "decision": {"type": "string", "enum": ["stop", "continue"]}
            },
            "required": ["decision"],
            "additionalProperties": False,
        }

    # ---------------------------------------------------------------- parsing

    def _validate_decision(self, result: Dict) -> bool:
        """Non-empty strategy/reasoning and an integer value
        (reference bcg_agents.py:734-743; tightened to reject non-int
        values that salvage parsing could produce)."""
        val = result.get("value")
        internal = result.get("internal_strategy", "")
        reasoning = result.get("public_reasoning", "")
        return (
            isinstance(val, int)
            and not isinstance(val, bool)
            and isinstance(internal, str)
            and len(internal.strip()) > 0
            and isinstance(reasoning, str)
            and len(reasoning.strip()) > 0
        )

    def parse_decision_response(self, result: Dict, game_state: Dict) -> Optional[int]:
        """Clamp to range, record reasoning/strategy; None on failure
        (reference bcg_agents.py:603-638)."""
        current_round = game_state.get("round", 0)
        lo, hi = self.value_range

        if result is None or "error" in result:
            self.last_reasoning = "JSON PARSING FAILED - no response"
            return None
        value = result.get("value")
        if value is None:
            self.last_reasoning = "No value provided - agent abstains"
            return None
        if isinstance(value, bool) or not isinstance(value, int):
            # Salvaged (unguided) JSON can carry a non-int value; treat as
            # abstain instead of crashing the round.
            self.last_reasoning = "Non-integer value provided - agent abstains"
            return None
        value = int(max(lo, min(hi, value)))
        self.last_reasoning = result.get("public_reasoning", "Value proposed")[
            :REASONING_STATE_LIMIT
        ]
        self._record_internal_strategy(current_round, result.get("internal_strategy", ""))
        return value

    def parse_vote_response(self, result: Dict, game_state: Dict) -> bool:
        """stop -> True, anything else -> False (reference bcg_agents.py:662-681)."""
        if result is None or "error" in result:
            return False
        return result.get("decision", "continue").lower().strip() == "stop"
