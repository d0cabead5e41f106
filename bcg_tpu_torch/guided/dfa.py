"""Regex AST -> byte-level DFA.

Thompson construction to an epsilon-NFA, then subset construction over
*byte equivalence classes* (bytes that behave identically in every char
class are merged), which keeps subset construction fast even with the
full 0..255 alphabet.  Output is a dense int32 transition table — the
host-side input to the token-level DFA builder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Set, Tuple

import numpy as np

from bcg_tpu_torch.guided.regex_ast import Alt, Bounded, CharClass, Epsilon, Node, Seq, Star


@dataclass
class CharDFA:
    """Dense byte-level DFA.

    transitions: int32 [num_states, 256], -1 = reject
    accepting:   bool  [num_states]
    start:       int
    """

    transitions: np.ndarray
    accepting: np.ndarray
    start: int

    @property
    def num_states(self) -> int:
        return self.transitions.shape[0]

    def matches(self, data: bytes) -> bool:
        state = self.start
        for b in data:
            state = int(self.transitions[state, b])
            if state < 0:
                return False
        return bool(self.accepting[state])


class _NFA:
    """Epsilon-NFA under construction: states are ints, edges are either
    epsilon or labelled with a frozenset of bytes."""

    def __init__(self):
        self.eps: List[Set[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def new_state(self) -> int:
        self.eps.append(set())
        self.edges.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int) -> None:
        self.eps[a].add(b)

    def add_edge(self, a: int, chars: FrozenSet[int], b: int) -> None:
        self.edges[a].append((chars, b))


def _build_nfa(node: Node, nfa: _NFA) -> Tuple[int, int]:
    """Thompson construction; returns (start, accept) state pair."""
    if isinstance(node, Epsilon):
        s = nfa.new_state()
        return s, s
    if isinstance(node, CharClass):
        s, t = nfa.new_state(), nfa.new_state()
        nfa.add_edge(s, node.chars, t)
        return s, t
    if isinstance(node, Seq):
        start, cur = None, None
        for part in node.parts:
            ps, pt = _build_nfa(part, nfa)
            if start is None:
                start = ps
            else:
                nfa.add_eps(cur, ps)
            cur = pt
        return start, cur
    if isinstance(node, Alt):
        s, t = nfa.new_state(), nfa.new_state()
        for option in node.options:
            os_, ot = _build_nfa(option, nfa)
            nfa.add_eps(s, os_)
            nfa.add_eps(ot, t)
        return s, t
    if isinstance(node, Star):
        s, t = nfa.new_state(), nfa.new_state()
        is_, it = _build_nfa(node.inner, nfa)
        nfa.add_eps(s, is_)
        nfa.add_eps(s, t)
        nfa.add_eps(it, is_)
        nfa.add_eps(it, t)
        return s, t
    if isinstance(node, Bounded):
        # Chain of max_count copies; an epsilon exit after every count in
        # [min_count, max_count].  Iterative: depth independent of count.
        exit_state = nfa.new_state()
        start = nfa.new_state()
        cur = start
        if node.min_count == 0:
            nfa.add_eps(cur, exit_state)
        for i in range(1, node.max_count + 1):
            is_, it = _build_nfa(node.inner, nfa)
            nfa.add_eps(cur, is_)
            cur = it
            if i >= node.min_count:
                nfa.add_eps(cur, exit_state)
        return start, exit_state
    raise TypeError(f"Unknown AST node: {node!r}")


def _collect_classes(node: Node, out: Set[FrozenSet[int]]) -> None:
    if isinstance(node, CharClass):
        out.add(node.chars)
    elif isinstance(node, Seq):
        for p in node.parts:
            _collect_classes(p, out)
    elif isinstance(node, Alt):
        for o in node.options:
            _collect_classes(o, out)
    elif isinstance(node, Star):
        _collect_classes(node.inner, out)
    elif isinstance(node, Bounded):
        _collect_classes(node.inner, out)


def _byte_equivalence(classes: Set[FrozenSet[int]]) -> Tuple[np.ndarray, int]:
    """Map each byte to an equivalence class id: two bytes are equivalent
    iff they belong to exactly the same set of char classes."""
    signatures: Dict[int, Tuple[bool, ...]] = {}
    ordered = sorted(classes, key=lambda c: sorted(c))
    for b in range(256):
        signatures[b] = tuple(b in c for c in ordered)
    sig_to_id: Dict[Tuple[bool, ...], int] = {}
    byte_class = np.zeros(256, dtype=np.int32)
    for b in range(256):
        sig = signatures[b]
        if sig not in sig_to_id:
            sig_to_id[sig] = len(sig_to_id)
        byte_class[b] = sig_to_id[sig]
    return byte_class, len(sig_to_id)


def ast_to_dfa(node: Node) -> CharDFA:
    """Subset construction over byte equivalence classes."""
    nfa = _NFA()
    start, accept = _build_nfa(node, nfa)

    # Per-NFA-state epsilon closures, memoized; a set's closure is the
    # union of its members' closures.
    closure_cache: Dict[int, FrozenSet[int]] = {}

    def state_closure(s: int) -> FrozenSet[int]:
        hit = closure_cache.get(s)
        if hit is not None:
            return hit
        out: Set[int] = set()
        stack = [s]
        while stack:
            cur = stack.pop()
            if cur in out:
                continue
            out.add(cur)
            stack.extend(nfa.eps[cur])
        result = frozenset(out)
        closure_cache[s] = result
        return result

    def closure(states: FrozenSet[int]) -> FrozenSet[int]:
        out: Set[int] = set()
        for s in states:
            out |= state_closure(s)
        return frozenset(out)

    classes: Set[FrozenSet[int]] = set()
    _collect_classes(node, classes)
    byte_class, num_classes = _byte_equivalence(classes)
    # One representative byte per class.
    rep_byte = np.zeros(num_classes, dtype=np.int32)
    for b in range(255, -1, -1):
        rep_byte[byte_class[b]] = b

    start_set = closure(frozenset((start,)))
    state_ids: Dict[FrozenSet[int], int] = {start_set: 0}
    worklist = [start_set]
    trans_by_class: List[np.ndarray] = []

    while worklist:
        current = worklist.pop()
        cid = state_ids[current]
        while len(trans_by_class) <= cid:
            trans_by_class.append(np.full(num_classes, -1, dtype=np.int32))
        row = trans_by_class[cid]
        # For each byte class, compute the move set.
        for k in range(num_classes):
            b = int(rep_byte[k])
            move: Set[int] = set()
            for s in current:
                for chars, t in nfa.edges[s]:
                    if b in chars:
                        move.add(t)
            if not move:
                continue
            target = closure(frozenset(move))
            if target not in state_ids:
                state_ids[target] = len(state_ids)
                worklist.append(target)
            row[k] = state_ids[target]

    num_states = len(state_ids)
    transitions = np.full((num_states, 256), -1, dtype=np.int32)
    for sid in range(num_states):
        transitions[sid] = trans_by_class[sid][byte_class]
    accepting = np.zeros(num_states, dtype=bool)
    for sset, sid in state_ids.items():
        if accept in sset:
            accepting[sid] = True
    return CharDFA(transitions=transitions, accepting=accepting, start=0)
