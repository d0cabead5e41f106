"""Batched guided-decoding state for the decode loop (port of
``bcg_tpu/guided/processor.py``; the schema compiler half is unchanged).

``GuidedBatch`` stacks one or more compiled token DFAs as torch tensors on
the engine's device and exposes the three per-step operations, all O(1)
gathers on device:

* ``token_mask(states)``  — [B, V] bool, which tokens each sequence may emit
* ``eos_allowed(states)`` — [B] bool, whether EOS is legal (accepting state)
* ``step(states, toks)``  — [B] int32 next DFA states

Per-sequence ``dfa_ids`` mean one batch can mix schemas (honest and
Byzantine agents decode together — the reference's vLLM path degrades to
sequential calls in that case, vllm_agent.py:417-455).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from bcg_tpu_torch.guided.dfa import ast_to_dfa
from bcg_tpu_torch.guided.schema_compiler import schema_to_ast
from bcg_tpu_torch.guided.token_dfa import TokenDFA, build_token_dfa


@dataclass
class SchemaGuide:
    """One schema compiled against one vocabulary."""

    token_dfa: TokenDFA
    schema_key: str
    vocab_key: Tuple[int, int]  # (vocab_id, vocab_len) — see compile_schema


_cache: Dict[Tuple[str, int], SchemaGuide] = {}
_cache_lock = threading.Lock()


def schema_cache_key(schema: dict) -> str:
    # Property declaration ORDER is semantic for object schemas (keys must
    # be emitted in schema order), so the key must NOT sort dict keys —
    # two schemas differing only in property order need different automata.
    return json.dumps(schema, sort_keys=False, separators=(",", ":"))


def compile_schema(
    schema: dict,
    token_bytes: Sequence[bytes],
    vocab_id: int = 0,
    force_numpy: bool = False,
    compact: bool = False,
) -> SchemaGuide:
    """Schema -> token DFA, cached per (schema, vocabulary, compactness).

    ``vocab_id`` identifies the tokenizer (vocabularies are large; callers
    pass a stable id rather than hashing the bytes).  The vocabulary size
    is folded into the key as a safety net against id collisions.
    ``compact=True`` removes inter-token whitespace from the GENERATION
    grammar (fewer decoded tokens, longer forced skeleton chains)."""
    key = (
        ("compact:" if compact else "") + schema_cache_key(schema),
        vocab_id, len(token_bytes),
    )
    with _cache_lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    from bcg_tpu_torch.guided.regex_ast import EPS

    char_dfa = ast_to_dfa(schema_to_ast(schema, ws=EPS if compact else None))
    token_dfa = build_token_dfa(char_dfa, token_bytes, force_numpy=force_numpy)
    guide = SchemaGuide(
        token_dfa=token_dfa, schema_key=key[0], vocab_key=(vocab_id, len(token_bytes))
    )
    with _cache_lock:
        _cache[key] = guide
    return guide


# Device-resident stacked tables, keyed by the (order-normalized) set of
# schemas in the batch plus the device.  The game re-uses the same schema
# combos every round (honest+Byzantine decide, honest+Byzantine vote);
# without this cache each LLM call re-uploads the [dfas, states, vocab]
# tables — tens of MB per call.
_table_cache: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_table_cache_lock = threading.Lock()
# Bound the cache so long sweeps over many configs (value_range is embedded
# in the schema text, so every config mints new keys) can't pin device
# memory without end.
_TABLE_CACHE_MAX = 8
# int16 sentinel for "token forbidden / acceptance unreachable" in the
# min-budget table; any real budget (max_tokens) is far below it.
_MINB_INF = np.iinfo(np.int16).max


class GuidedBatch:
    """Stacked DFAs + per-sequence assignment, on a torch device.

    ``tables`` int16 (int32 past 32K states) ``[n_dfa, n_states, V]``,
    ``accepting`` bool ``[n_dfa, n_states]``, ``min_budget`` int16
    ``[n_dfa, n_states, V]``, ``dfa_ids`` / ``init_states`` int32 ``[B]``.
    The forced-chain tables of the fast-forward loop are not built: that
    loop is not ported yet (ROADMAP A7)."""

    def __init__(self, guides: List[SchemaGuide], device="cpu"):
        """``guides[i]`` is the guide for batch row i.  Distinct guides are
        deduplicated (by schema, sorted so combo order doesn't matter);
        tables are padded to the largest state count."""
        import torch

        device = torch.device(device)
        by_key: Dict[Tuple, SchemaGuide] = {}
        for g in guides:
            by_key.setdefault((g.schema_key, g.vocab_key), g)
        unique = [by_key[k] for k in sorted(by_key)]
        index = {(g.schema_key, g.vocab_key): i for i, g in enumerate(unique)}
        dfa_ids = [index[(g.schema_key, g.vocab_key)] for g in guides]

        vocab = unique[0].token_dfa.vocab_size
        # Same table-cache key as the JAX package (tokenizer identity, not
        # just the paddable vocab size), plus the device the tables live on.
        cache_key = (
            tuple((g.schema_key, g.vocab_key) for g in unique), vocab, str(device)
        )
        with _table_cache_lock:
            hit = _table_cache.get(cache_key)
            if hit is not None:
                _table_cache.move_to_end(cache_key)
        if hit is None:
            s_max = max(g.token_dfa.num_states for g in unique)
            tables = np.full((len(unique), s_max, vocab), -1, dtype=np.int32)
            accepting = np.zeros((len(unique), s_max), dtype=bool)
            # min_budget[u, s, t]: tokens of budget (including t itself)
            # needed to take token t from state s and still reach
            # acceptance; _MINB_INF where t is forbidden — the decode-step
            # feasibility test is one row-gather + compare.
            minb = np.full((len(unique), s_max, vocab), _MINB_INF, dtype=np.int16)
            starts = np.zeros(len(unique), dtype=np.int32)
            for i, g in enumerate(unique):
                td = g.token_dfa
                tables[i, : td.num_states] = td.transitions
                accepting[i, : td.num_states] = td.accepting
                valid = td.transitions >= 0
                nd = td.dist[np.clip(td.transitions, 0, None)].astype(np.int64) + 1
                minb[i, : td.num_states] = np.where(
                    valid, np.minimum(nd, _MINB_INF), _MINB_INF
                ).astype(np.int16)
                starts[i] = td.start
            # State counts are small (<100 for the BCG schemas); int16
            # halves the device footprint of the stacked table.
            if s_max < np.iinfo(np.int16).max:
                tables = tables.astype(np.int16)
            hit = (
                torch.from_numpy(tables).to(device),
                torch.from_numpy(accepting).to(device),
                torch.from_numpy(minb).to(device),
                starts,
            )
            with _table_cache_lock:
                _table_cache[cache_key] = hit
                while len(_table_cache) > _TABLE_CACHE_MAX:
                    _table_cache.popitem(last=False)
        self.tables, self.accepting, self.min_budget, starts = hit
        ids = np.array(dfa_ids, dtype=np.int32)
        self.dfa_ids = torch.from_numpy(ids).to(device)
        self.init_states = torch.from_numpy(starts[ids]).to(device)
        self.num_unique = len(unique)

    # The per-step device ops (shapes: states [B], tokens [B]).

    def token_mask(self, states):
        """[B, V] bool — allowed next tokens per sequence."""
        clamped = states.clamp(min=0).long()
        return self.tables[self.dfa_ids.long(), clamped] >= 0

    def eos_allowed(self, states):
        clamped = states.clamp(min=0).long()
        return self.accepting[self.dfa_ids.long(), clamped] | (states < 0)

    def step(self, states, tokens):
        """Advance DFA states by the sampled tokens.  A negative state is
        sticky (sequence already finished/rejected)."""
        import torch

        clamped = states.clamp(min=0).long()
        nxt = self.tables[self.dfa_ids.long(), clamped, tokens.long()].to(torch.int32)
        return torch.where(states < 0, states.to(torch.int32), nxt)

    @classmethod
    def permissive(cls, batch_size: int, vocab_size: int, device="cpu") -> "GuidedBatch":
        """A one-state always-accepting automaton allowing every token —
        unguided generation running through the same decode loop."""
        import torch

        self = cls.__new__(cls)
        self.tables = torch.zeros((1, 1, vocab_size), dtype=torch.int16, device=device)
        self.accepting = torch.ones((1, 1), dtype=torch.bool, device=device)
        self.min_budget = torch.ones((1, 1, vocab_size), dtype=torch.int16, device=device)
        self.dfa_ids = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        self.init_states = torch.zeros((batch_size,), dtype=torch.int32, device=device)
        self.num_unique = 1
        return self
