"""The reference's own schema check, written from the configuration's
statement of the serving grammar and nothing of the program's.

Two checks of a served decision:

* :func:`validate` reads the finished text as JSON and holds the value to
  its JSON schema (types, ranges, enums, required and extra keys,
  ``minLength``): an answer judged by what it says.
* :class:`Automaton` is the byte-level grammar that guided decoding
  serves, as the configuration states it: an object's members in schema
  order, at most three of space, newline and tab between structural
  tokens, strings of printable ASCII with the escapes ``\\" \\\\ \\/ \\n
  \\t \\r \\b \\f``, integers as their canonical decimal, enum values as
  their ``json.dumps`` form.  It gives, at each position of a served row,
  the set of tokens that a sampler holding to the grammar and to the
  row's token budget may pick, which the logit comparison needs: a
  greedy row's token is the best of that set.

The grammar is built as a Thompson NFA over bytes (one token is one byte
under the byte tokenizer); state sets are memoized, so the walk is a
lazily built DFA.
"""

from __future__ import annotations

import json
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

STRING_BYTES = frozenset(range(0x20, 0x7F)) - {0x22, 0x5C}
ESCAPE_BYTES = frozenset(b'"\\/ntrbf')
WS_BYTES = frozenset(b" \n\t")
MAX_INT_RANGE = 100_000


# ------------------------------------------------------------------ grammar
# Nodes: ("lit", bytes) | ("cls", frozenset) | ("seq", [..]) | ("alt", [..])
# | ("opt", node) | ("star", node)

def _lit(s: str):
    return ("lit", s.encode("ascii"))


def _seq(*parts):
    return ("seq", list(parts))


def _alt(*parts):
    return ("alt", list(parts))


WS = _seq(("opt", ("cls", WS_BYTES)), ("opt", ("cls", WS_BYTES)), ("opt", ("cls", WS_BYTES)))
STRING_CHAR = _alt(("cls", STRING_BYTES), _seq(_lit("\\"), ("cls", ESCAPE_BYTES)))


def _scalar(v):
    if isinstance(v, (dict, list)):
        raise NotImplementedError(f"enum of a container: {v!r}")
    return _lit(json.dumps(v, ensure_ascii=True))


def schema_node(schema: Dict):
    """The grammar of one schema's serialized values."""
    if "enum" in schema:
        return _alt(*(_scalar(v) for v in schema["enum"]))
    if "const" in schema:
        return _scalar(schema["const"])
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return _alt(*(schema_node(s) for s in schema[key]))
    kind = schema.get("type")
    if kind == "object":
        return _object_node(schema)
    if kind == "string":
        if "pattern" in schema:
            raise NotImplementedError("string pattern")
        lo, hi = int(schema.get("minLength", 0)), schema.get("maxLength")
        body = [STRING_CHAR] * lo
        if hi is None:
            body.append(("star", STRING_CHAR))
        else:
            body += [("opt", STRING_CHAR)] * (int(hi) - lo)
        return _seq(_lit('"'), *body, _lit('"'))
    if kind == "integer":
        lo, hi = schema.get("minimum"), schema.get("maximum")
        if lo is None or hi is None or int(hi) - int(lo) > MAX_INT_RANGE:
            raise NotImplementedError("integer without a small closed range")
        return _alt(*(_lit(str(i)) for i in range(int(lo), int(hi) + 1)))
    if kind == "boolean":
        return _alt(_lit("true"), _lit("false"))
    if kind == "null":
        return _lit("null")
    raise NotImplementedError(f"schema {schema!r}")


def _object_node(schema: Dict):
    props = schema.get("properties", {})
    required = set(schema.get("required", []))
    names = list(props)
    if not names:
        return _seq(_lit("{"), WS, _lit("}"))
    flags = [n in required for n in names]
    if not flags[0] or any(not a and b for a, b in zip(flags, flags[1:])):
        raise NotImplementedError("object whose optional members are not a suffix")
    members = [_seq(_lit(json.dumps(n)), WS, _lit(":"), WS, schema_node(props[n]))
               for n in names]
    body = [members[0]]
    for member, req in zip(members[1:], flags[1:]):
        group = _seq(WS, _lit(","), WS, member)
        body.append(group if req else ("opt", group))
    return _seq(_lit("{"), WS, *body, WS, _lit("}"))


# --------------------------------------------------------------------- NFA

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.edges: List[List[Tuple[FrozenSet[int], int]]] = []

    def new(self) -> int:
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1

    def build(self, node, s: int, e: int) -> None:
        kind = node[0]
        if kind == "lit":
            cur = s
            data = node[1]
            for i, b in enumerate(data):
                nxt = e if i == len(data) - 1 else self.new()
                self.edges[cur].append((frozenset([b]), nxt))
                cur = nxt
            if not data:
                self.eps[s].append(e)
        elif kind == "cls":
            self.edges[s].append((node[1], e))
        elif kind == "seq":
            cur = s
            parts = node[1]
            if not parts:
                self.eps[s].append(e)
            for i, part in enumerate(parts):
                nxt = e if i == len(parts) - 1 else self.new()
                self.build(part, cur, nxt)
                cur = nxt
        elif kind == "alt":
            for part in node[1]:
                self.build(part, s, e)
        elif kind == "opt":
            self.eps[s].append(e)
            self.build(node[1], s, e)
        elif kind == "star":
            a, b = self.new(), self.new()
            self.eps[s].append(a)
            self.eps[a].append(e)
            self.build(node[1], a, b)
            self.eps[b].append(a)
        else:
            raise ValueError(kind)


class Automaton:
    """The serving grammar of one schema, walked a byte at a time.

    States are frozensets of NFA states (closed under empty moves);
    ``None`` is the dead state."""

    def __init__(self, schema: Dict):
        nfa = _NFA()
        start, self._accept = nfa.new(), nfa.new()
        nfa.build(schema_node(schema), start, self._accept)
        self._nfa = nfa
        self._dist = self._distances()
        self.start = self._closure([start])
        self._memo: Dict[Tuple[FrozenSet[int], int], Optional[FrozenSet[int]]] = {}

    def _closure(self, states) -> FrozenSet[int]:
        seen = set(states)
        todo = list(states)
        while todo:
            for t in self._nfa.eps[todo.pop()]:
                if t not in seen:
                    seen.add(t)
                    todo.append(t)
        return frozenset(seen)

    def _distances(self) -> List[float]:
        """Fewest bytes from each NFA state to acceptance (0-1 BFS over
        the reversed graph: empty moves cost 0, byte moves 1)."""
        n = len(self._nfa.eps)
        rev: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for u in range(n):
            for v in self._nfa.eps[u]:
                rev[v].append((u, 0))
            for _, v in self._nfa.edges[u]:
                rev[v].append((u, 1))
        dist = [float("inf")] * n
        dist[self._accept] = 0
        dq = deque([self._accept])
        while dq:
            v = dq.popleft()
            for u, w in rev[v]:
                if dist[v] + w < dist[u]:
                    dist[u] = dist[v] + w
                    (dq.appendleft if w == 0 else dq.append)(u)
        return dist

    def step(self, state: Optional[FrozenSet[int]], byte: int) -> Optional[FrozenSet[int]]:
        if state is None:
            return None
        key = (state, byte)
        if key in self._memo:
            return self._memo[key]
        targets = [t for s in state for cls, t in self._nfa.edges[s] if byte in cls]
        out = self._closure(targets) if targets else None
        self._memo[key] = out
        return out

    def accepting(self, state: Optional[FrozenSet[int]]) -> bool:
        return state is not None and self._accept in state

    def distance(self, state: Optional[FrozenSet[int]]) -> float:
        """Fewest further bytes to acceptance (inf for the dead state)."""
        if state is None:
            return float("inf")
        return min(self._dist[s] for s in state)

    def allowed(self, state, budget_left: int) -> List[int]:
        """Bytes a budget-respecting sampler may take from ``state`` with
        ``budget_left`` tokens of the row's budget left (this one
        included): the byte's successor must still reach acceptance
        within the rest."""
        out = []
        for b in range(256):
            nxt = self.step(state, b)
            if nxt is not None and self.distance(nxt) + 1 <= budget_left:
                out.append(b)
        return out


_AUTOMATA: Dict[str, Automaton] = {}


def automaton(schema: Dict) -> Automaton:
    key = json.dumps(schema, sort_keys=True)
    a = _AUTOMATA.get(key)
    if a is None:
        a = _AUTOMATA[key] = Automaton(schema)
    return a


def walk(schema: Dict, served: Sequence[int], budget: int, eos_id: int
         ) -> Tuple[Optional[str], List[Tuple[List[int], bool]]]:
    """Walk a served row (byte tokens, then ``eos_id`` if emitted)
    through the grammar.  Returns ``(fault, positions)``: ``fault`` names
    the first token the grammar or the budget did not allow (None if
    every token was allowed and the row ends accepted), and ``positions``
    holds, for each served token, the candidate bytes and whether EOS was
    a candidate."""
    a = automaton(schema)
    state = a.start
    positions: List[Tuple[List[int], bool]] = []
    for j, tok in enumerate(served):
        cands = a.allowed(state, budget - j)
        eos_ok = a.accepting(state)
        positions.append((cands, eos_ok))
        if tok == eos_id:
            if not eos_ok:
                return f"EOS at {j} before the value is complete", positions
            if j != len(served) - 1:
                return f"tokens after EOS at {j}", positions
            return None, positions
        if tok not in cands:
            return f"token {tok} at {j} not allowed", positions
        state = a.step(state, tok)
    if not a.accepting(state):
        return "row ends before the value is complete", positions
    return None, positions


# ---------------------------------------------------------------- validator

def validate(value, schema: Dict) -> Optional[str]:
    """None if ``value`` (parsed JSON) obeys ``schema``, else why not."""
    if "enum" in schema:
        return None if any(value == v and type(value) is type(v) for v in schema["enum"]) \
            else f"{value!r} not in enum"
    if "const" in schema:
        return None if value == schema["const"] else f"{value!r} != const"
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return None if any(validate(value, s) is None for s in schema[key]) \
                else f"{value!r} matches no branch of {key}"
    kind = schema.get("type")
    if kind == "object":
        if not isinstance(value, dict):
            return "not an object"
        props = schema.get("properties", {})
        for name in schema.get("required", []):
            if name not in value:
                return f"missing {name!r}"
        if schema.get("additionalProperties") is False:
            extra = set(value) - set(props)
            if extra:
                return f"extra keys {sorted(extra)}"
        for name, sub in props.items():
            if name in value:
                why = validate(value[name], sub)
                if why:
                    return f"{name}: {why}"
        return None
    if kind == "string":
        if not isinstance(value, str):
            return "not a string"
        if len(value) < int(schema.get("minLength", 0)):
            return "shorter than minLength"
        if schema.get("maxLength") is not None and len(value) > int(schema["maxLength"]):
            return "longer than maxLength"
        return None
    if kind == "integer":
        if isinstance(value, bool) or not isinstance(value, int):
            return "not an integer"
        if "minimum" in schema and value < schema["minimum"]:
            return "below minimum"
        if "maximum" in schema and value > schema["maximum"]:
            return "above maximum"
        return None
    if kind == "boolean":
        return None if isinstance(value, bool) else "not a boolean"
    if kind == "null":
        return None if value is None else "not null"
    raise NotImplementedError(f"schema {schema!r}")


def check_text(text: Optional[str], schema: Dict) -> Optional[str]:
    """None if the served text parses as JSON and obeys its schema."""
    if text is None:
        return "no text"
    try:
        value = json.loads(text)
    except json.JSONDecodeError as e:
        return f"not JSON: {e}"
    return validate(value, schema)
