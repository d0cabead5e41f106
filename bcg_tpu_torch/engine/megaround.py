"""On-device mega-round: one fused program per consensus round — the
port of ``bcg_tpu/engine/megaround.py``.

The lockstep game loop issues 2 host-orchestrated engine calls per
round (decide + vote), each with its own host syncs (the port's lockstep
P1 round makes 106, ``PERF.md`` §5).  This module fuses the WHOLE round
— per-agent prompt assembly from device-resident game state, guided
decode, DFA-walk decision parse, topology-masked proposal exchange,
vote decode, tally and consensus check — into one sequence of device
work with ONE packed readback, so the host only streams results and
game events.

The template plan is the JAX package's, copied unchanged (everything
above :func:`build_round_program`): the round prompts are a fixed ASCII
skeleton with fixed-width decimal SLOTS (zero-padded values,
``'-'*width`` for absent), so every agent's prompt tokenizes to the
same length and a round's dynamic state (values / inbox / round number)
enters the program as integer tensors gathered into pre-tokenized token
tables — never as host strings.  This requires a byte-stable tokenizer
(``engine.tokenizer.is_byte_stable``: token positions == byte offsets);
BPE vocabularies raise :class:`MegaroundUnsupported` and the
orchestrator falls back to the lockstep path.

:func:`build_round_program` is an eager PyTorch program with the JAX
program's order of work.  Every per-round quantity is a device tensor
argument, and nothing in it reads the device from the host: the
engine's one ``round_readback`` is the round's only host sync.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from bcg_tpu_torch.engine.tokenizer import (
    Tokenizer,
    is_byte_stable,
    number_token_table,
)


class MegaroundUnsupported(Exception):
    """This game/engine configuration cannot run the fused round; the
    caller must fall back to the lockstep path (never silently — the
    orchestrator warns once and counts the fallback)."""


def decision_schema(lo: int, hi: int) -> Dict:
    """Integer-only decision schema: the JSON skeleton contains no
    digit characters, so the in-jit decimal parse
    (``guided.token_dfa.parse_int_values``) reads exactly the value."""
    return {
        "type": "object",
        "properties": {
            "value": {"type": "integer", "minimum": lo, "maximum": hi}
        },
        "required": ["value"],
        "additionalProperties": False,
    }


def vote_schema() -> Dict:
    """Vote as an integer: 1 = stop, 0 = continue.  Numeric on purpose —
    the same in-jit parse serves both phases, and an invalid emission
    parses to -1, which the round program maps to CONTINUE exactly like
    the lockstep orchestrator's failed-vote default."""
    return {
        "type": "object",
        "properties": {
            "value": {"type": "integer", "minimum": 0, "maximum": 1}
        },
        "required": ["value"],
        "additionalProperties": False,
    }


@dataclass(frozen=True)
class MegaroundTemplate:
    """Host-side renderer of the mega-round prompt family.

    The SAME renderer feeds three consumers, which is what makes the
    gate's oracle-identity check meaningful: the device plan tokenizes
    these strings, the perf_gate oracle feeds them through the ordinary
    ``batch_generate_json`` path, and the FakeEngine mirror answers them
    with its stock policies (the slot lines deliberately match its
    ``agent_\\w+ value: (-?\\d+)`` / ``Your current value:`` regexes;
    absent slots render ``'-'*width``, which correctly fails them).
    """

    n_agents: int
    lo: int
    hi: int
    max_rounds: int

    @property
    def val_width(self) -> int:
        return max(len(str(self.hi)), len(str(max(self.lo, 0))))

    @property
    def round_width(self) -> int:
        return len(str(max(self.max_rounds, 1)))

    @property
    def agent_width(self) -> int:
        return len(str(max(self.n_agents - 1, 0)))

    def name(self, i: int) -> str:
        return f"agent_{i:0{self.agent_width}d}"

    def _slot(self, v: int) -> str:
        w = self.val_width
        return "-" * w if v is None or v < 0 else str(int(v)).zfill(w)

    def _round_slot(self, r: int) -> str:
        return str(int(r)).zfill(self.round_width)

    def system_prompt(self, i: int) -> str:
        return (
            f"You are {self.name(i)} in a consensus game. Propose an "
            "integer value each round and vote to stop once agents agree."
        )

    def _user(
        self, tail: str, round_num: int, own: int, inbox_row: Sequence[int]
    ) -> Tuple[str, Dict]:
        """Render one user prompt, returning (text, char offsets of each
        slot) — offsets are byte offsets too (the template is ASCII,
        asserted at plan build)."""
        segs: List[str] = []
        offsets: Dict = {"inbox": []}
        pos = 0

        def add(s: str) -> None:
            nonlocal pos
            segs.append(s)
            pos += len(s)

        add("Round ")
        offsets["round"] = pos
        add(self._round_slot(round_num))
        add(". Peer proposals:")
        for j in range(self.n_agents):
            add(f" {self.name(j)} value: ")
            offsets["inbox"].append(pos)
            add(self._slot(inbox_row[j]))
            add(".")
        add(" Your current value: ")
        offsets["own"] = pos
        add(self._slot(own))
        add(". " + tail)
        return "".join(segs), offsets

    _DECIDE_TAIL = 'Decide your value. Respond with JSON {"value": N}.'
    _VOTE_TAIL = (
        "Vote on stopping. Respond with JSON value one to stop, "
        "zero to continue."
    )

    def decision_user(
        self, round_num: int, own: int, inbox_row: Sequence[int]
    ) -> str:
        return self._user(self._DECIDE_TAIL, round_num, own, inbox_row)[0]

    def vote_user(
        self, round_num: int, own: int, inbox_row: Sequence[int]
    ) -> str:
        return self._user(self._VOTE_TAIL, round_num, own, inbox_row)[0]

    def decision_prompts(
        self, values: Sequence[int], inbox, round_num: int
    ) -> List[Tuple[str, str, Dict]]:
        """(system, user, schema) rows for the decision phase — the
        oracle form the perf_gate feeds to ``batch_generate_json``."""
        schema = decision_schema(self.lo, self.hi)
        return [
            (
                self.system_prompt(i),
                self.decision_user(round_num, values[i], inbox[i]),
                schema,
            )
            for i in range(self.n_agents)
        ]

    def vote_prompts(
        self, values: Sequence[int], received, round_num: int
    ) -> List[Tuple[str, str, Dict]]:
        schema = vote_schema()
        return [
            (
                self.system_prompt(i),
                self.vote_user(round_num, values[i], received[i]),
                schema,
            )
            for i in range(self.n_agents)
        ]


@dataclass
class PhasePlan:
    """Pre-tokenized token buffers + static slot layout for one phase.

    ``base`` is [N, L] int32, LEFT-padded into the engine's length
    bucket with every slot filled with the "absent" row of the value
    table; the *_col fields are the (row-uniform) token columns each
    slot occupies — static at trace time, so assembly is N+2 in-place
    column updates per phase inside the jit."""

    base: np.ndarray          # [N, L] int32
    valid: np.ndarray         # [N, L] bool
    L: int                    # padded (bucketed) prompt window
    prompt_len: int           # real tokens per row (uniform)
    inbox_cols: Tuple[int, ...]
    own_col: int
    round_col: int
    max_new: int
    schema: Dict

    @property
    def prefix_len(self) -> int:
        """Columns [0, prefix_len) never change across rounds — the
        left pad plus the chat/system prefix up to the FIRST dynamic
        slot.  The engine prefills this region ONCE per plan and every
        fused round prefills only the suffix against the cached KV
        (``transformer.prefill_with_prefix``) — the same prefix reuse
        the lockstep path gets from the radix cache, without per-round
        host work."""
        return min((self.round_col, self.own_col) + self.inbox_cols)


@dataclass
class MegaroundPlan:
    """Everything static about a game's fused round: the template, the
    per-phase token buffers, and the shared slot token tables."""

    template: MegaroundTemplate
    decide: PhasePlan
    vote: PhasePlan
    val_table: np.ndarray     # [hi-lo+2, val_width] int32; row 0 = absent
    round_table: np.ndarray   # [max_rounds+1, round_width] int32
    digit_len: np.ndarray     # [V] int32 (guided parse tables)
    digit_val: np.ndarray     # [V] int32

    @property
    def n_agents(self) -> int:
        return self.template.n_agents

    def static_key(self) -> Tuple:
        """The compile-key contribution of the plan's STATIC layout —
        everything the program closes over.  Two games with identical
        layout share one compiled round program; round number, values,
        inbox, and convergence state are traced arguments and can never
        appear here (the retrace-pinning contract)."""
        def phase_key(p: PhasePlan) -> Tuple:
            return (p.L, p.prompt_len, p.inbox_cols, p.own_col,
                    p.round_col, p.max_new)

        return (
            self.n_agents, self.template.lo, self.template.hi,
            self.template.max_rounds, phase_key(self.decide),
            phase_key(self.vote),
        )


def _bucket(length: int, limit: int, ladder: Sequence[int]) -> int:
    """The engine's prompt-window bucketing (jax_engine._encode_leftpad
    semantics): smallest ladder rung >= length, doubling past the tail,
    capped at the row limit but never below the real length."""
    buckets = list(ladder)
    while buckets[-1] < limit:
        buckets.append(buckets[-1] * 2)
    L = next((b for b in buckets if b >= length), limit)
    return max(min(L, limit), length)


def _build_phase(
    template: MegaroundTemplate,
    tokenizer: Tokenizer,
    chat_parts,
    tail: str,
    schema: Dict,
    max_new: int,
    max_model_len: int,
    ladder: Sequence[int],
) -> PhasePlan:
    n = template.n_agents
    absent = [-1] * n
    rows = []
    layout = None
    for i in range(n):
        user, offsets = template._user(tail, 0, -1, absent)
        prefix, suffix = chat_parts(template.system_prompt(i), user)
        full = prefix + suffix
        if not full.isascii():
            raise MegaroundUnsupported(
                "chat template produced non-ASCII text — slot byte "
                "offsets would not equal char offsets"
            )
        if full.count(user) != 1:
            raise MegaroundUnsupported(
                "user prompt not uniquely locatable inside the chat "
                "template rendering"
            )
        user_off = full.index(user)
        toks = tokenizer.encode(full)
        if len(toks) != len(full.encode("utf-8")):
            raise MegaroundUnsupported(
                "tokenizer is not byte-stable on the rendered template"
            )
        row_layout = (
            tuple(user_off + o for o in offsets["inbox"]),
            user_off + offsets["own"],
            user_off + offsets["round"],
            len(toks),
        )
        if layout is None:
            layout = row_layout
        elif layout != row_layout:
            raise MegaroundUnsupported(
                "per-agent prompts disagree on slot layout (non-uniform "
                "token lengths)"
            )
        rows.append(toks)
    inbox_cols, own_col, round_col, prompt_len = layout
    limit = max_model_len - max_new - 1
    if prompt_len > limit:
        raise MegaroundUnsupported(
            f"template prompt ({prompt_len} tokens) + budget ({max_new}) "
            f"exceeds max_model_len={max_model_len}"
        )
    L = _bucket(prompt_len, limit, ladder)
    pad = L - prompt_len
    base = np.full((n, L), tokenizer.pad_id, dtype=np.int32)
    valid = np.zeros((n, L), dtype=bool)
    for i, toks in enumerate(rows):
        base[i, pad:] = toks
        valid[i, pad:] = True
    return PhasePlan(
        base=base, valid=valid, L=L, prompt_len=prompt_len,
        inbox_cols=tuple(pad + c for c in inbox_cols),
        own_col=pad + own_col, round_col=pad + round_col,
        max_new=max_new, schema=schema,
    )


def _verify_phase(
    plan: PhasePlan,
    template: MegaroundTemplate,
    tokenizer: Tokenizer,
    chat_parts,
    tail: str,
) -> None:
    """Probe the arithmetic slot layout against a real render: fill the
    last inbox slot, the own slot, and the round slot with extreme
    values, re-tokenize, and require the token diff to land EXACTLY in
    the recorded columns.  An offset bug becomes a loud build failure,
    never a silently-wrong prompt."""
    n = template.n_agents
    inbox = [-1] * n
    inbox[n - 1] = template.hi
    user, _ = template._user(tail, template.max_rounds, template.lo, inbox)
    prefix, suffix = chat_parts(template.system_prompt(0), user)
    got = np.asarray(tokenizer.encode(prefix + suffix), dtype=np.int32)
    want = plan.base[0, plan.L - plan.prompt_len:].copy()
    W, Wr = template.val_width, template.round_width
    pad = plan.L - plan.prompt_len

    def put(col: int, text: str) -> None:
        toks = tokenizer.encode(text)
        want[col - pad: col - pad + len(toks)] = toks

    put(plan.inbox_cols[n - 1], str(template.hi).zfill(W))
    put(plan.own_col, str(template.lo).zfill(W))
    put(plan.round_col, str(template.max_rounds).zfill(Wr))
    if got.shape != want.shape or not np.array_equal(got, want):
        raise MegaroundUnsupported(
            "slot-splice verification failed: arithmetic token layout "
            "does not match a reference tokenization"
        )


def build_plan(
    template: MegaroundTemplate,
    tokenizer: Tokenizer,
    chat_parts,
    max_model_len: int,
    ladder: Sequence[int],
    max_new_decide: Optional[int] = None,
    max_new_vote: Optional[int] = None,
) -> MegaroundPlan:
    """Build (and VERIFY) the device plan for a game's fused rounds.

    ``chat_parts`` is ``(system, user) -> (prefix, suffix)`` — the
    engine binds its model's chat template so plan tokenization matches
    the lockstep path byte-for-byte (the oracle-identity requirement).
    Raises :class:`MegaroundUnsupported` on any configuration the fused
    round cannot represent exactly.
    """
    from bcg_tpu_torch.guided.token_dfa import digit_token_tables

    if not is_byte_stable(tokenizer):
        raise MegaroundUnsupported(
            "tokenizer is not byte-stable (BPE merges would re-segment "
            "template slots)"
        )
    if template.n_agents < 1:
        raise MegaroundUnsupported("no agents")
    if template.lo < 0:
        raise MegaroundUnsupported(
            "negative value ranges collide with the -1 abstain encoding"
        )
    # Budget: JSON skeleton ('{"value": ' + digits + '}') + EOS + slack.
    # The gate's oracle arm passes the SAME budget to the lockstep call,
    # so guaranteed-parse masking binds identically in both paths.
    default_new = template.val_width + 16
    max_new_decide = max_new_decide or default_new
    max_new_vote = max_new_vote or default_new
    val_table, _ = number_token_table(
        tokenizer, template.lo, template.hi, width=template.val_width
    )
    round_rows = [
        str(r).zfill(template.round_width)
        for r in range(template.max_rounds + 1)
    ]
    round_table = np.zeros(
        (len(round_rows), template.round_width), dtype=np.int32
    )
    for r, text in enumerate(round_rows):
        toks = tokenizer.encode(text)
        if len(toks) != template.round_width:
            raise MegaroundUnsupported("round slot not byte-stable")
        round_table[r] = toks
    decide = _build_phase(
        template, tokenizer, chat_parts, template._DECIDE_TAIL,
        decision_schema(template.lo, template.hi), max_new_decide,
        max_model_len, ladder,
    )
    vote = _build_phase(
        template, tokenizer, chat_parts, template._VOTE_TAIL,
        vote_schema(), max_new_vote, max_model_len, ladder,
    )
    _verify_phase(decide, template, tokenizer, chat_parts,
                  template._DECIDE_TAIL)
    _verify_phase(vote, template, tokenizer, chat_parts,
                  template._VOTE_TAIL)
    digit_len, digit_val = digit_token_tables(tokenizer.token_bytes())
    return MegaroundPlan(
        template=template, decide=decide, vote=vote,
        val_table=val_table, round_table=round_table,
        digit_len=digit_len, digit_val=digit_val,
    )


@dataclass
class MegaroundResult:
    """One fused round's outputs, as host arrays after the single
    readback.  ``proposed`` is the raw per-agent decision (-1 = the
    guided emission failed to parse — abstain, exactly the lockstep
    invalid-decision outcome); ``values`` the post-apply current values
    (abstainers keep their previous value)."""

    proposed: np.ndarray      # [n] int32
    values: np.ndarray        # [n] int32 post-round current values
    received: np.ndarray      # [n, n] int32, -1 = not delivered
    deliveries: np.ndarray    # [n] int32 proposals delivered per receiver
    vote_raw: np.ndarray      # [n] int32 {1, 0, -1 invalid}
    votes: np.ndarray         # [n] int32 {1 stop, 0 continue}
    stop: int
    cont: int
    terminate: bool
    has_consensus: bool
    consensus_value: int
    agreement_pct: float
    syncs: int = 1

    def vote_dict(self, agent_ids: Sequence[str]) -> Dict[str, Optional[bool]]:
        """The ``game.advance_round`` vote mapping: True = stop, False =
        continue (including parse failures — the lockstep default)."""
        return {
            aid: bool(self.votes[i] == 1) for i, aid in enumerate(agent_ids)
        }


def build_round_program(plan: MegaroundPlan, engine):
    """The fused round as ONE function over device tensors of game state.

    Closes over only STATIC layout (slot columns, shapes, budgets);
    every per-round quantity — values, inbox, round index,
    Byzantine/initial vectors, the guided tables — is a device tensor
    argument, so one program serves every round of a plan layout (the
    engine memoizes it under the plan's static key).  The JAX program's
    order of work, eagerly: slot assembly by gather, the suffix prefill
    against the per-plan prefix cache, the plain guided decode loop
    (greedy, every step: no "all done" poll), the DFA walk and integer
    parse, apply-proposals, the equivocation spread and masked exchange,
    the vote phase on the received matrix, vote -> {1, 0}, tally and
    consensus.  Returns the 14 outputs as device tensors; no operation
    in it synchronizes with the host.
    """
    import torch

    from bcg_tpu_torch.guided.token_dfa import parse_int_values, walk_token_dfa
    from bcg_tpu_torch.models.transformer import prefill_with_prefix
    from bcg_tpu_torch.parallel.game_step import (
        check_consensus_dense,
        equivocate_proposals,
        masked_exchange_matrix,
        tally_votes_dense,
    )

    spec = engine.spec
    eos_id = engine.tokenizer.eos_id
    n = plan.n_agents
    lo = plan.template.lo
    hi = plan.template.hi
    W = plan.template.val_width
    Wr = plan.template.round_width
    phases = {"decide": plan.decide, "vote": plan.vote}

    def assemble(phase: PhasePlan, base, val_table, round_table,
                 inbox, own, round_idx):
        idx = torch.where(inbox >= 0, inbox - lo + 1, 0).long()       # [n, n]
        own_idx = torch.where(own >= 0, own - lo + 1, 0).long()       # [n]
        toks = base.clone()
        for j, c in enumerate(phase.inbox_cols):
            toks[:, c:c + W] = val_table[idx[:, j]]
        toks[:, phase.own_col:phase.own_col + W] = val_table[own_idx]
        # index_select, not round_table[round_idx]: a 0-dim index would
        # be read on the host.
        toks[:, phase.round_col:phase.round_col + Wr] = (
            round_table.index_select(0, round_idx.view(1)).expand(n, Wr)
        )
        return toks

    def run_phase(name, params, base, valid, pcache, val_table,
                  round_table, inbox, own, round_idx, guided, digits):
        phase = phases[name]
        S = phase.L + phase.max_new + 1
        P = phase.prefix_len
        toks = assemble(phase, base, val_table, round_table,
                        inbox, own, round_idx)
        # Static-prefix split: the round-invariant columns [0, P) are in
        # ``pcache`` (prefilled once per plan, engine.run_megaround) —
        # each round prefills only the slot-bearing suffix, written in
        # place at [P, L), with RoPE positions continuing where the
        # cached prefix ended.  Slots past the suffix hold the previous
        # round's values, masked until the decode loop rewrites them.
        first_logits, cache = prefill_with_prefix(
            params, spec, toks[:, P:].long(), valid[:, P:], pcache,
            valid[:, :P], valid[:, :P].sum(dim=1).to(torch.int32),
        )
        valid_mask = torch.zeros((n, S), dtype=torch.bool, device=base.device)
        valid_mask[:, :phase.L] = valid
        prompt_lens = valid.sum(dim=1).to(torch.int32)
        out, steps = engine._decode_loop(
            cache, first_logits, valid_mask, prompt_lens, phase.L, guided,
            torch.zeros((n,), dtype=torch.float32, device=base.device),   # greedy
            torch.full((n,), phase.max_new, dtype=torch.int32, device=base.device),
            phase.max_new, 1.0, entry="megaround", poll=False,
        )
        final_states = walk_token_dfa(guided.tables, guided.dfa_ids,
                                      guided.init_states, out, eos_id)
        parsed = parse_int_values(
            out, eos_id, digits[0], digits[1], final_states,
            guided.accepting, guided.dfa_ids,
        )
        return parsed, steps

    def program(params, base_d, valid_d, pcache_d, base_v, valid_v,
                pcache_v, val_table, round_table, digits, values, inbox,
                round_idx, receiver_mask, is_byzantine, initial_values,
                equivocators, guided_d, guided_v):
        proposed, steps_d = run_phase(
            "decide", params, base_d, valid_d, pcache_d, val_table,
            round_table, inbox, values, round_idx, guided_d, digits,
        )
        # Apply-proposals semantics: an abstainer keeps its old value.
        new_values = torch.where(proposed >= 0, proposed, values)
        # Per-receiver exchange: equivocating senders (a [n] bool tensor
        # argument — the program is strategy-agnostic) spread their
        # proposal across receivers; with equivocators all-False the
        # matrix is the plain broadcast.
        proposal_matrix = equivocate_proposals(
            proposed, equivocators, lo, hi
        )
        received, deliveries = masked_exchange_matrix(
            proposal_matrix, receiver_mask
        )
        vote_raw, steps_v = run_phase(
            "vote", params, base_v, valid_v, pcache_v, val_table,
            round_table, received, new_values, round_idx, guided_v, digits,
        )
        # Invalid vote emission -> CONTINUE (the lockstep failed-vote
        # default) — the fused round never abstains a vote.
        votes = torch.where(vote_raw == 1, 1, 0).to(torch.int32)
        tally = tally_votes_dense(votes)
        consensus = check_consensus_dense(
            new_values, is_byzantine, initial_values
        )
        return (
            proposed, new_values, received, deliveries, vote_raw, votes,
            tally["stop"], tally["continue"], tally["terminate"],
            consensus["has_consensus"], consensus["consensus_value"],
            consensus["agreement_pct"], steps_d, steps_v,
        )

    return program
