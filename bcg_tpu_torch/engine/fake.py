"""Deterministic fake inference engine for hermetic tests.

The reference has no test backend (SURVEY.md §4); every piece of game
logic upstream of the LLM is untestable there without a GPU.  This engine
implements the full :class:`InferenceEngine` contract with deterministic,
game-aware behaviour so the orchestrator, retry ladder, metrics, and CLI
run end-to-end on any machine in milliseconds.

Policies
--------
* ``consensus`` (default): honest-looking behaviour that converges — for
  decision schemas it proposes the most common value visible in the
  prompt (ties -> smallest), falling back to the agent's current value or
  the schema's midpoint; for vote schemas it votes "stop" iff every value
  mentioned in the current-round section agrees.
* ``schema_min``: emits the minimal schema-conforming object.
* ``disrupt``: for Byzantine-shaped schemas (value accepts "abstain"),
  proposes values far from the observed mode and votes "continue".
* ``stubborn``: never follows — keeps the agent's current value forever
  (drives the no-consensus / timeout paths deterministically).
* ``median``: proposes the median of the observed values (a slower,
  order-statistic convergence dynamic than the mode-attractor).
* ``oscillate``: alternates between the schema's extremes by round
  parity and votes "continue" (a value-flipping adversary).
* ``mimic``: joins the observed mode but always votes "stop" — the
  infiltration adversary that tries to freeze consensus early on a
  value it helped pick.
* ``silent``: abstains wherever the schema allows (decision and vote).
* ``clique``: every byzantine row pushes ONE seed-derived decoy value
  (``scenarios.strategies.clique_target`` — the shared secret needs no
  runtime coordination channel) and votes "continue".
* ``adaptive``: proposes the modular antipode of the observed mode —
  the margin-targeting adversary, scripted.
* ``equivocate``: proposes a deterministic per-round base value; the
  EXCHANGE layer (per-receiver proposal matrix) spreads it so each
  receiver sees a different variant.

ROLE-AWARE MIXES: ``"mixed:<honest_policy>:<byzantine_policy>"`` applies
different policies by ROW, detecting Byzantine rows from their schema
shape (decision ``value`` carries the ``anyOf[int, "abstain"]`` form;
vote enums include ``"abstain"`` — agents/byzantine.py).  This turns the
fake backend into a scripted fault-model lab: adversary strategies
become a seeded, LLM-free experimental axis (e.g.
``--fake-policy mixed:consensus:oscillate``), something the reference —
whose only fault model is the LLM itself — cannot do hermetically.

Failure injection: ``fail_first_n_calls`` makes the first N ``*_json``
calls return invalid results, exercising the orchestrator's batch-retry →
sequential fallback ladder (reference main.py:293-341).
"""

from __future__ import annotations

import random
import re
from collections import Counter
from typing import Any, Dict, List, Tuple

from bcg_tpu_torch.engine.interface import InferenceEngine
from bcg_tpu_torch.obs import (
    counters as obs_counters,
    hostsync as obs_hostsync,
    tracer as obs_tracer,
)
from bcg_tpu_torch.runtime import envflags

# Matches per-agent proposal lines in round summaries ("agent_3 value: 17"),
# not the agent's own "Your current value: N" line.
_VALUE_RE = re.compile(r"agent_\w+ value: (-?\d+)")
_CURRENT_RE = re.compile(r"[Yy]our current value: (-?\d+)")
# Case-insensitive: the real decision prompts use an uppercase
# "=== ROUND N ===" header while history lines say "Round N: ..." —
# callers take the MAX match (the current round never trails history).
_ROUND_RE = re.compile(r"round (\d+)", re.IGNORECASE)

from bcg_tpu_torch.scenarios.strategies import SCRIPTED_POLICIES

HONEST_POLICIES = ("consensus", "schema_min", "stubborn", "median")
# The strategy library's scripted mirrors (clique/adaptive/equivocate)
# extend the hand-rolled adversary policies — one source of truth for
# which byzantine policies exist (scenarios/strategies.py).
BYZANTINE_POLICIES = (
    "disrupt", "oscillate", "mimic", "silent"
) + SCRIPTED_POLICIES


def _schema_bounds(schema: Dict[str, Any]) -> Tuple[int, int]:
    """Extract integer bounds from a decision schema (handles the Byzantine
    anyOf[int, "abstain"] form)."""
    vs = schema.get("properties", {}).get("value", {})
    if "anyOf" in vs:
        for option in vs["anyOf"]:
            if option.get("type") == "integer":
                vs = option
                break
    return int(vs.get("minimum", 0)), int(vs.get("maximum", 100))


def _is_vote_schema(schema: Dict[str, Any]) -> bool:
    return "decision" in schema.get("properties", {})


def _vote_options(schema: Dict[str, Any]) -> List[str]:
    return schema["properties"]["decision"].get("enum", ["stop", "continue"])


class FakeEngine(InferenceEngine):
    def __init__(
        self,
        seed: int = 0,
        policy: str = "consensus",
        fail_first_n_calls: int = 0,
    ):
        # Validate at CONSTRUCTION: a typo'd policy name would otherwise
        # silently fall through to the consensus branch, recording
        # honest-baseline numbers as adversary results.
        known = set(HONEST_POLICIES) | set(BYZANTINE_POLICIES)
        if policy.startswith("mixed:"):
            parts = policy.split(":")
            if (len(parts) != 3 or parts[1] not in HONEST_POLICIES
                    or parts[2] not in BYZANTINE_POLICIES):
                raise ValueError(
                    f"fake policy {policy!r}: expected "
                    f"'mixed:<honest>:<byzantine>' with honest in "
                    f"{HONEST_POLICIES} and byzantine in {BYZANTINE_POLICIES}"
                )
        elif policy not in known:
            raise ValueError(
                f"unknown fake policy {policy!r}: expected one of "
                f"{sorted(known)} or 'mixed:<honest>:<byzantine>'"
            )
        self.rng = random.Random(seed)
        self.seed = seed  # clique policy derives its shared target from this
        self.policy = policy
        self.fail_first_n_calls = fail_first_n_calls
        self.call_count = 0  # counts individual JSON generations
        self.batch_calls = 0
        # Fused mega-round mirror (run_megaround): same stats shape as
        # JaxEngine.megaround_stats so bench/trace tooling is hermetic.
        self.megaround_rounds = 0
        self.megaround_seconds = 0.0

    # ------------------------------------------------------------- free text

    def generate(self, prompt, temperature=0.0, max_tokens=256, top_p=1.0,
                 system_prompt=None) -> str:
        return f"[fake:{len(prompt)}ch]"

    def batch_generate(self, prompts, temperature=0.0, max_tokens=256, top_p=1.0):
        return [self.generate(p) for p in prompts]

    # ------------------------------------------------------------------ JSON

    def generate_json(self, prompt, schema, temperature=0.0, max_tokens=512,
                      system_prompt=None) -> Dict[str, Any]:
        self.call_count += 1
        if self.call_count <= self.fail_first_n_calls:
            return {"error": "fake_injected_failure", "message": "injected"}
        if isinstance(prompt, tuple):  # (shared_core, tail) vote prompts
            prompt = "".join(prompt)
        return self._respond(system_prompt or "", prompt, schema)

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        """Mirrors the JaxEngine span taxonomy (``engine.prefill`` =
        prompt normalization, ``engine.decode`` = response synthesis) so
        hermetic serving traces are structurally realistic — the
        acceptance trace of a FakeEngine game nests the same span names
        a TPU run would."""
        self.batch_calls += 1
        with obs_tracer.span("engine.prefill", args={"rows": len(prompts)}):
            rows = []
            for system_prompt, user_prompt, schema in prompts:
                if isinstance(user_prompt, tuple):  # (shared_core, tail)
                    user_prompt = "".join(user_prompt)
                rows.append((system_prompt, user_prompt, schema))
            # Hermetic host-sync mirror (the engine.spec.* idiom): one
            # batched JaxEngine call performs exactly these device->host
            # materializations — the prefill timing barrier, then the
            # decode-loop output + step-count readbacks below.  Mirrored
            # here so a FakeEngine game carries the REAL loop's
            # syncs-per-round structure (2 batched calls x 3 syncs per
            # lockstep round).  ROADMAP item 1's on-device mega-round
            # (run_megaround below) collapses that to ONE round_readback
            # per round — perf_gate's 'hostsync' scenario pins both
            # profiles (no-ops unless BCG_TPU_HOSTSYNC is on).
            obs_hostsync.note("prefill_barrier", entry="prefill")
        out = []
        with obs_tracer.span("engine.decode", args={"rows": len(rows)}):
            for system_prompt, user_prompt, schema in rows:
                self.call_count += 1
                if self.call_count <= self.fail_first_n_calls:
                    out.append(
                        {"error": "fake_injected_failure", "message": "injected"}
                    )
                else:
                    out.append(self._respond(system_prompt, user_prompt, schema))
            # Spec-on calls run the real engine's spec loop, so ALL
            # post-loop readbacks attribute to its entry name there —
            # mirror the same attribution (jax_engine.py loop_entry).
            loop_entry = (
                "spec_decode_loop"
                if envflags.get_bool("BCG_TPU_SPEC") else "decode_loop"
            )
            obs_hostsync.note("decode_readback", entry=loop_entry)
            obs_hostsync.note("steps_readback", entry=loop_entry)
        self._mirror_speculation(rows, out)
        obs_hostsync.publish()
        return out

    def _mirror_speculation(self, rows, results) -> None:
        """Hermetic mirror of the JaxEngine speculative-decoding
        control flow (BCG_TPU_SPEC): run the REAL prompt-lookup
        reference drafter (engine/speculative.py, the same oracle the
        device drafter is conformance-tested against) over
        character-level tokens of prompt + response, accepting exactly
        the draft prefixes that agree with the actual response — so
        hermetic traces and serving stats carry structurally realistic
        ``engine.spec.*`` counters and the ``engine.spec_verify`` span
        without a device."""
        from bcg_tpu_torch.runtime.envflags import get_bool, get_int

        if not get_bool("BCG_TPU_SPEC"):
            return
        import json as _json

        from bcg_tpu_torch.engine.speculative import spec_mirror_np

        n = get_int("BCG_TPU_SPEC_NGRAM")
        k = get_int("BCG_TPU_SPEC_K")
        with obs_tracer.span(
            "engine.spec_verify", args={"rows": len(rows), "k": k, "ngram": n}
        ):
            drafted = accepted = 0
            for (system_prompt, user_prompt, _), result in zip(rows, results):
                # The reference drafter is an O(history x output) pure-
                # Python oracle; cap the scanned history so a long-prompt
                # hermetic run stays milliseconds per row (echoes worth
                # drafting are recent anyway).
                d, a, _iters = spec_mirror_np(
                    list((system_prompt + user_prompt).encode()[-4096:]),
                    list(_json.dumps(result).encode()),
                    n, k,
                )
                drafted += d
                accepted += a
        # Host-sync mirror of the spec arm: the real spec loop reads the
        # drafted/accepted vectors back (2 extra materializations per
        # call — jax_engine.py spec_readback), so a spec-on hermetic
        # game must carry 5 syncs/call, not the plain loop's 3.
        obs_hostsync.note("spec_readback", n=2, entry="spec_decode_loop")
        if drafted:
            obs_counters.inc("engine.spec.drafted", drafted)
            obs_counters.inc("engine.spec.accepted", accepted)
            obs_counters.inc("engine.spec.rejected", drafted - accepted)

    # ------------------------------------------------------------ mega-round

    def prepare_megaround(self, n_agents: int, lo: int, hi: int,
                          max_rounds: int):
        """Hermetic mega-round plan: just the template renderer — the
        fake mirror answers the rendered prompts directly, so there is
        no tokenized buffer to build.  Mirrors the real plan builder's
        value-range gate (negative ranges collide with the -1 absent
        encoding) so fallback behaviour is identical under test."""
        from bcg_tpu_torch.engine.megaround import (
            MegaroundTemplate,
            MegaroundUnsupported,
        )

        if lo < 0:
            raise MegaroundUnsupported(
                f"value_range ({lo}, {hi}): negative values collide with "
                "the -1 absent/abstain encoding"
            )
        return MegaroundTemplate(
            n_agents=n_agents, lo=lo, hi=hi, max_rounds=max_rounds
        )

    def run_megaround(self, plan, values, inbox, round_num,
                      receiver_mask, is_byzantine, initial_values,
                      equivocators=None):
        """One fused round, hermetically: the stock decision policies
        answer the SAME rendered template prompts the device plan
        tokenizes, then exchange/tally/consensus run as the numpy mirror
        of ``parallel.game_step``'s dense bodies.  Carries the fused
        entry's exact sync profile — ONE ``round_readback`` note per
        round instead of the lockstep 2 calls x 3 syncs — so hermetic
        hostsync gates measure the real path's structure.

        The retry ladder never sees fused rounds, so
        ``fail_first_n_calls`` injection does not apply here (a fused
        parse failure IS the -1/abstain outcome, not a retryable error).
        """
        import time

        import numpy as np

        from bcg_tpu_torch.engine.megaround import MegaroundResult

        template = getattr(plan, "template", plan)
        n = template.n_agents
        values = np.asarray(values, dtype=np.int32)
        inbox = np.asarray(inbox, dtype=np.int32)
        mask = np.asarray(receiver_mask, dtype=bool)
        is_byz = np.asarray(is_byzantine, dtype=bool)
        initials = np.asarray(initial_values, dtype=np.int32)
        equiv = (
            np.zeros(n, dtype=bool) if equivocators is None
            else np.asarray(equivocators, dtype=bool)
        )

        # Mega-round prompts are uniform integer-only schemas, so the
        # mixed-policy schema-shape dispatch (_policy_for) is blind to
        # roles here — dispatch per ROW on the is_byzantine array the
        # fused entry already receives.
        def row_policy(i: int) -> str:
            if not self.policy.startswith("mixed:"):
                return self.policy
            _, honest_p, byz_p = self.policy.split(":")
            return byz_p if is_byz[i] else honest_p

        t0 = time.perf_counter()
        with obs_tracer.span(
            "engine.megaround", args={"rows": n, "round": int(round_num)}
        ):
            proposed = np.empty(n, dtype=np.int32)
            for i, (_system, user, schema) in enumerate(
                template.decision_prompts(values, inbox, round_num)
            ):
                out = self._decide(user, schema, row_policy(i))
                v = out.get("value")
                proposed[i] = int(v) if isinstance(v, int) else -1
            new_values = np.where(proposed >= 0, proposed, values).astype(
                np.int32
            )
            # Per-receiver exchange + tally: numpy twins of game_step's
            # equivocate_proposals / masked_exchange_matrix /
            # tally_votes_dense / check_consensus_dense.  Column j of
            # the proposal matrix is constant unless sender j
            # equivocates, in which case each receiver row gets its own
            # deterministic variant.
            proposal_matrix = np.broadcast_to(
                proposed[None, :], (n, n)
            ).astype(np.int32)
            if equiv.any():
                from bcg_tpu_torch.scenarios.strategies import equivocation_value

                recv_idx = np.arange(n, dtype=np.int32)[:, None]
                spread = equivocation_value(
                    proposed[None, :], recv_idx, template.lo, template.hi
                )
                proposal_matrix = np.where(
                    equiv[None, :] & (proposed >= 0)[None, :],
                    spread, proposal_matrix,
                ).astype(np.int32)
            delivered = mask & (proposal_matrix >= 0)
            received = np.where(delivered, proposal_matrix, -1).astype(
                np.int32
            )
            deliveries = delivered.sum(axis=1).astype(np.int32)
            # Vote phase: `_vote`'s rules over what each receiver's
            # rendered vote prompt shows (own new value + delivered
            # peers; dash slots match no regex) — computed from the same
            # arrays the renderer reads, so prompt and vote agree.
            vote_raw = np.zeros(n, dtype=np.int32)
            for i in range(n):
                policy = row_policy(i)
                if policy in ("disrupt", "oscillate", "clique",
                              "adaptive", "equivocate"):
                    vote_raw[i] = 0
                elif policy == "mimic":
                    vote_raw[i] = 1
                else:
                    seen = [int(v) for v in received[i] if v >= 0]
                    if new_values[i] >= 0:
                        seen.append(int(new_values[i]))
                    vote_raw[i] = 1 if seen and len(set(seen)) == 1 else 0
            votes = np.where(vote_raw == 1, 1, 0).astype(np.int32)
            stop = int((votes == 1).sum())
            honest_valid = (~is_byz) & (new_values >= 0)
            n_honest = int(honest_valid.sum())
            same = (
                honest_valid[:, None]
                & honest_valid[None, :]
                & (new_values[:, None] == new_values[None, :])
            )
            counts = np.where(honest_valid, same.sum(axis=1), 0)
            modal_idx = int(np.argmax(counts))
            ref = int(new_values[modal_idx])
            modal_count = int(counts[modal_idx])
            agreement = (
                modal_count / max(n_honest, 1) * 100.0 if n_honest else 0.0
            )
            from_initial = bool(
                ((initials == ref) & ~is_byz & (initials >= 0)).any()
            )
            # The fused entry's single packed readback.
            obs_hostsync.note("round_readback", entry="megaround")
        self.megaround_rounds += 1
        self.megaround_seconds += time.perf_counter() - t0
        obs_counters.inc("engine.megaround.rounds")
        obs_hostsync.publish()
        from bcg_tpu_torch.runtime import metrics as _metrics

        _metrics.publish_megaround(self.megaround_stats())
        return MegaroundResult(
            proposed=proposed,
            values=new_values,
            received=received,
            deliveries=deliveries,
            vote_raw=vote_raw,
            votes=votes,
            stop=stop,
            cont=n - stop,
            terminate=stop * 3 >= n * 2,
            has_consensus=(modal_count == n_honest and n_honest > 0)
            and from_initial,
            consensus_value=ref,
            agreement_pct=float(agreement),
        )

    def megaround_stats(self) -> Dict[str, Any]:
        """Same shape as ``JaxEngine.megaround_stats`` (bench contract)."""
        return {
            "fused_rounds": self.megaround_rounds,
            "syncs_per_round": 1.0 if self.megaround_rounds else 0.0,
            "rounds_per_sec": (
                self.megaround_rounds / self.megaround_seconds
                if self.megaround_seconds > 0
                else 0.0
            ),
        }

    # ---------------------------------------------------------------- policy

    def _policy_for(self, schema: Dict) -> str:
        """Row policy: a plain policy applies to every row; a
        ``mixed:<honest>:<byz>`` policy dispatches on the schema's role
        shape (Byzantine decision schemas carry anyOf[int, "abstain"];
        Byzantine vote enums include "abstain" — agents/byzantine.py)."""
        if not self.policy.startswith("mixed:"):
            return self.policy
        parts = self.policy.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"fake policy {self.policy!r}: expected 'mixed:<honest>:<byzantine>'"
            )
        _, honest_p, byz_p = parts
        if _is_vote_schema(schema):
            is_byz = "abstain" in _vote_options(schema)
        else:
            is_byz = "anyOf" in schema.get("properties", {}).get("value", {})
        return byz_p if is_byz else honest_p

    def _respond(self, system_prompt: str, user_prompt: str, schema: Dict) -> Dict:
        policy = self._policy_for(schema)
        if _is_vote_schema(schema):
            return self._vote(user_prompt, schema, policy)
        return self._decide(user_prompt, schema, policy)

    def _decide(self, prompt: str, schema: Dict, policy: str) -> Dict:
        lo, hi = _schema_bounds(schema)
        observed = [int(v) for v in _VALUE_RE.findall(prompt)]
        current = _CURRENT_RE.search(prompt)
        current_value = int(current.group(1)) if current else None
        allows_abstain = "anyOf" in schema.get("properties", {}).get("value", {})

        if policy == "schema_min":
            value: Any = lo
        elif policy == "stubborn":
            # Never follows: the deterministic no-consensus dynamic.
            # Clamp like every other numeric branch — an out-of-range
            # "Your current value" line must not yield a schema-
            # violating emission.
            value = current_value if current_value is not None else (lo + hi) // 2
            value = max(lo, min(hi, value))
        elif policy == "median":
            if observed:
                ordered = sorted(observed)
                value = ordered[len(ordered) // 2]
            else:
                value = current_value if current_value is not None else (lo + hi) // 2
            value = max(lo, min(hi, value))
        elif policy == "disrupt":
            # Push away from the observed mode; occasionally abstain when
            # the schema allows it.
            if allows_abstain and self.rng.random() < 0.2:
                value = "abstain"
            elif observed:
                mode = Counter(observed).most_common(1)[0][0]
                value = hi if mode <= (lo + hi) // 2 else lo
            else:
                value = self.rng.randint(lo, hi)
        elif policy == "oscillate":
            # Value-flipping adversary: alternates extremes by round
            # parity (stateless — the round number is in the prompt;
            # max() because history lines mention earlier rounds too).
            rounds_seen = [int(x) for x in _ROUND_RE.findall(prompt)]
            rnd = max(rounds_seen) if rounds_seen else 0
            value = hi if rnd % 2 == 0 else lo
        elif policy == "mimic":
            # Infiltration adversary: joins the mode (looks honest)...
            if observed:
                counts = Counter(observed)
                best = max(counts.values())
                value = min(v for v, c in counts.items() if c == best)
            else:
                value = (lo + hi) // 2
            value = max(lo, min(hi, value))
        elif policy == "silent":
            value = "abstain" if allows_abstain else lo
        elif policy == "clique":
            # Colluding clique: every byzantine row derives the SAME
            # decoy value from the engine seed — the shared-target
            # agreement oracle in the perf gate's scenarios arm.
            from bcg_tpu_torch.scenarios.strategies import clique_target

            value = clique_target(self.seed, lo, hi)
        elif policy == "adaptive":
            # Margin-targeting adversary, scripted: the modular antipode
            # of the observed mode — always the value farthest (mod
            # span) from where honest agents are converging.
            span = hi - lo + 1
            if observed:
                mode = Counter(observed).most_common(1)[0][0]
                mode = max(lo, min(hi, mode))
                value = lo + (mode - lo + span // 2) % span
            else:
                value = hi
        elif policy == "equivocate":
            # Deterministic per-round base; the exchange layer spreads
            # it per-receiver (equivocation_value), so each receiver of
            # this sender sees a different variant.
            span = hi - lo + 1
            rounds_seen = [int(x) for x in _ROUND_RE.findall(prompt)]
            rnd = max(rounds_seen) if rounds_seen else 0
            value = lo + rnd % span
        else:  # consensus
            if observed:
                # most common, smallest on ties -> deterministic attractor
                counts = Counter(observed)
                best = max(counts.values())
                value = min(v for v, c in counts.items() if c == best)
            elif current_value is not None:
                value = current_value
            else:
                value = (lo + hi) // 2
            value = max(lo, min(hi, value))

        return {
            "internal_strategy": f"fake[{policy}] tracking {len(observed)} proposals",
            "value": value,
            "public_reasoning": f"Proposing {value} based on the visible round history.",
        }

    def _vote(self, prompt: str, schema: Dict, policy: str) -> Dict:
        options = _vote_options(schema)
        if (policy in ("disrupt", "oscillate", "clique", "adaptive",
                       "equivocate") and "continue" in options):
            return {"decision": "continue"}
        if policy == "silent" and "abstain" in options:
            return {"decision": "abstain"}
        if policy == "mimic" and "stop" in options:
            # ...and votes to freeze the game early on the value it
            # helped pick (the infiltration metric's target behaviour).
            return {"decision": "stop"}
        # Look only at the current-round section if present.
        section = prompt.split("PREVIOUS ROUNDS")[0]
        observed = [int(v) for v in re.findall(r": (-?\d+)", section)]
        unanimous = len(observed) > 0 and len(set(observed)) == 1
        decision = "stop" if unanimous and "stop" in options else "continue"
        return {"decision": decision}
