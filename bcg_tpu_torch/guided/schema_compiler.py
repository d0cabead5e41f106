"""JSON schema -> regex AST.

Covers the schema surface the BCG agents use (reference
bcg_agents.py:590-599, 651-659, 1083-1092, 1155-1163) plus the common
basics, mirroring what vLLM's guided decoding (outlines-style) accepts:

* ``object`` with ordered ``properties``, ``required`` subsets,
  ``additionalProperties: false``
* ``string`` (sanitised ASCII content with escapes) with
  ``minLength``/``maxLength`` or a ``pattern`` regex
  (guided/regex_parser.py), ``enum``/``const`` scalars
* ``integer`` with ``minimum``/``maximum`` and numeric
  ``exclusiveMinimum``/``exclusiveMaximum`` (tight digit-DP range regex)
* ``number``, ``boolean``, ``null``; ``array`` with
  ``minItems``/``maxItems`` (bounded whitespace)
* ``anyOf``/``oneOf`` alternation (the Byzantine ``int | "abstain"``
  case)

Anything outside this surface fails loudly at schema-compile time —
silent divergence from the author's schema is the one unacceptable
failure mode for a constrained decoder.

Strings are restricted to printable ASCII + escaped ``\\" \\\\ \\n \\t``:
the game prompts demand English-only output, and a byte-exact ASCII
automaton keeps the token DFA small and UTF-8-unambiguous.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from bcg_tpu_torch.guided.regex_ast import (
    DIGIT,
    EPS,
    CharClass,
    Node,
    alt,
    bounded,
    char,
    char_set,
    digit_range,
    literal,
    opt,
    plus,
    seq,
    star,
)

# Optional whitespace between structural JSON tokens — BOUNDED to three
# characters (the outlines/vLLM convention is similar:
# whitespace_pattern "[ \n\t]?").  An unbounded \s* gives a weak or
# adversarial model an infinite non-progress loop inside the automaton:
# with sharpened sampling it can emit whitespace until the token budget
# forces completion, turning a 25-token vote into max_tokens of decode.
# Three chars cover compact output and flat (depth-1) indent<=2
# pretty-printing; deeper indentation is out of grammar — fine for
# GENERATION (the mask simply forbids it), a caveat only if the DFA is
# reused to validate external pretty-printed JSON.
_WS_CHAR = char_set(" \n\t")
WS = seq(opt(_WS_CHAR), opt(_WS_CHAR), opt(_WS_CHAR))


def _json_value_literal(v) -> "Node":
    """One JSON SCALAR as an exact-serialization literal (enum/const).

    Containers are rejected: their single json.dumps serialization
    (", "-separated) would conflict with the grammar's own whitespace
    policy and silently fail compact-mode validation.
    """
    if not isinstance(v, (str, int, float, bool)) and v is not None:
        raise ValueError(
            f"Unsupported enum/const value {v!r}: only JSON scalars"
        )
    return literal(json.dumps(v, ensure_ascii=True))

# String content byte: printable ASCII except '"' and '\'.
_CONTENT = CharClass(
    frozenset(b for b in range(0x20, 0x7F) if b not in (0x22, 0x5C))
)
# Escape sequences: \" \\ \/ \n \t \r \b \f
_ESCAPE = seq(char("\\"), char_set('"\\/ntrbf'))
STRING_CHAR = alt(_CONTENT, _ESCAPE)


def string_ast(min_len: int = 0, max_len: Optional[int] = None) -> Node:
    if max_len is None:
        body = star(STRING_CHAR)
        if min_len > 0:
            body = seq(*([STRING_CHAR] * min_len), body)
    else:
        if max_len < min_len:
            raise ValueError(f"maxLength {max_len} < minLength {min_len}")
        body = bounded(STRING_CHAR, min_len, max_len)
    return seq(char('"'), body, char('"'))


def json_string_literal(value: str) -> Node:
    """AST for the canonical JSON serialization of ``value`` (quotes,
    escapes, and non-ASCII \\uXXXX included — embedding the raw string
    would mis-handle quotes/backslashes)."""
    return literal(json.dumps(value, ensure_ascii=True))


def _fixed_length_range(a: str, b: str) -> Node:
    """Digits-string regex for the closed range [a, b], len(a) == len(b)."""
    if not a:
        return EPS
    a0, b0 = int(a[0]), int(b[0])
    if a0 == b0:
        return seq(digit_range(a0, a0), _fixed_length_range(a[1:], b[1:]))
    parts = [seq(digit_range(a0, a0), _fixed_length_range(a[1:], "9" * (len(a) - 1)))]
    if b0 - a0 >= 2:
        tail = seq(*([DIGIT] * (len(a) - 1))) if len(a) > 1 else EPS
        parts.append(seq(digit_range(a0 + 1, b0 - 1), tail))
    parts.append(seq(digit_range(b0, b0), _fixed_length_range("0" * (len(b) - 1), b[1:])))
    return alt(*parts)


def _nonneg_range(lo: int, hi: int) -> Node:
    """Regex for integers lo..hi (0 <= lo <= hi), no leading zeros except
    the single digit 0."""
    assert 0 <= lo <= hi
    parts = []
    for length in range(len(str(lo)), len(str(hi)) + 1):
        lo_l = 0 if length == 1 else 10 ** (length - 1)
        hi_l = 10**length - 1
        a, b = max(lo, lo_l), min(hi, hi_l)
        if a > b:
            continue
        parts.append(_fixed_length_range(str(a), str(b)))
    return alt(*parts)


def _nonneg_at_least(lo: int) -> Node:
    """Regex for integers >= lo (lo >= 0), unbounded above: the exact
    range up to the same digit length, plus any longer digit string
    (no leading zeros => longer means larger)."""
    length = len(str(lo))
    exact = _nonneg_range(lo, 10**length - 1)
    longer = seq(digit_range(1, 9), *([DIGIT] * length), star(DIGIT))
    return alt(exact, longer)


def int_range_ast(lo: Any = None, hi: Any = None) -> Node:
    """Integer regex honouring optional bounds (either side may be open)."""
    if lo is None and hi is None:
        # -?(0|[1-9][0-9]*)
        return seq(opt(char("-")), alt(char("0"), seq(digit_range(1, 9), star(DIGIT))))
    if lo is not None and hi is not None and int(lo) > int(hi):
        raise ValueError(f"empty integer range [{lo}, {hi}]")

    parts = []
    # Non-negative side: allowed iff hi (when given) admits it.
    if hi is None:
        parts.append(_nonneg_at_least(max(int(lo), 0)))
    elif int(hi) >= 0:
        parts.append(_nonneg_range(max(int(lo), 0) if lo is not None else 0, int(hi)))
    # Negative side (-m): allowed iff lo is open or negative.
    if lo is None or int(lo) < 0:
        mag_hi = None if lo is None else -int(lo)           # largest magnitude
        mag_lo = 1 if (hi is None or int(hi) >= 0) else -int(hi)  # smallest
        if mag_hi is None:
            parts.append(seq(char("-"), _nonneg_at_least(mag_lo)))
        elif mag_hi >= mag_lo:
            parts.append(seq(char("-"), _nonneg_range(mag_lo, mag_hi)))
    return alt(*parts)


def number_ast() -> Node:
    """JSON number: -?int(.frac)?([eE][+-]?digits)?"""
    integer = alt(char("0"), seq(digit_range(1, 9), star(DIGIT)))
    frac = seq(char("."), plus(DIGIT))
    exp = seq(char_set("eE"), opt(char_set("+-")), plus(DIGIT))
    return seq(opt(char("-")), integer, opt(frac), opt(exp))


def schema_to_ast(schema: Dict[str, Any], ws: Optional[Node] = None) -> Node:
    """Compile a JSON schema into a regex AST for its serialized form.

    ``ws`` is the inter-token whitespace grammar: the bounded default
    ``WS`` (compact + shallow pretty-print forms), or ``EPS`` for
    compact-only GENERATION — fewer tokens to decode and longer
    DFA-forced skeleton chains for fast-forward (the parse direction is
    unaffected; emitted JSON is always valid either way)."""
    if ws is None:
        ws = WS
    for alt_key in ("enum", "anyOf", "oneOf"):
        if alt_key in schema and not schema[alt_key]:
            # An empty alternation compiles to a match-NOTHING automaton
            # whose first generation step dead-masks every token — fail
            # here, at the root cause, instead.
            raise ValueError(f"Unsupported schema: empty {alt_key}")

    if "enum" in schema:
        return alt(*(_json_value_literal(v) for v in schema["enum"]))

    if "const" in schema:  # const == a one-value enum
        return _json_value_literal(schema["const"])

    if "anyOf" in schema:
        return alt(*(schema_to_ast(s, ws) for s in schema["anyOf"]))

    if "oneOf" in schema:
        # For GENERATION, oneOf's at-most-one-branch exclusivity cannot
        # be enforced by an alternation automaton; like outlines, treat
        # it as anyOf (a value matching several branches is still a
        # value the author's schema accepts under any sane branch set).
        return alt(*(schema_to_ast(s, ws) for s in schema["oneOf"]))

    t = schema.get("type")
    if t == "object":
        return _object_ast(schema, ws)
    if t == "string":
        if "pattern" in schema:
            # pattern strings (reference parity: vLLM's outlines-style
            # guided decoding accepts them).  Enforcing pattern AND
            # length bounds simultaneously needs automaton intersection
            # — reject loudly instead of silently dropping one.
            if schema.get("minLength") or schema.get("maxLength") is not None:
                raise ValueError(
                    "string schema with BOTH pattern and "
                    "minLength/maxLength is not supported; encode the "
                    "length bound in the pattern itself"
                )
            from bcg_tpu_torch.guided.regex_parser import (
                json_escape_transform, parse_pattern,
            )

            value_ast = json_escape_transform(parse_pattern(schema["pattern"]))
            return seq(char('"'), value_ast, char('"'))
        return string_ast(
            min_len=schema.get("minLength", 0),
            max_len=schema.get("maxLength"),
        )
    if t == "integer":
        import math

        lo = schema.get("minimum")
        hi = schema.get("maximum")
        # Inclusive non-integral bounds: the smallest admissible
        # integer >= 4.5 is 5 (ceil), the largest <= 4.5 is 4 (floor)
        # — int() truncation would admit 4 for minimum=4.5.
        if lo is not None:
            lo = math.ceil(lo)
        if hi is not None:
            hi = math.floor(hi)
        # Exclusive bounds, draft-06+ NUMERIC form only (the draft-04
        # boolean form would silently mis-compile via int(True)).
        # floor/ceil handle non-integral bounds: the smallest integer
        # strictly above ex is floor(ex)+1, the largest strictly below
        # is ceil(ex)-1 — int() truncation is off by one for them.
        ex_lo = schema.get("exclusiveMinimum")
        ex_hi = schema.get("exclusiveMaximum")
        if isinstance(ex_lo, bool) or isinstance(ex_hi, bool):
            raise ValueError(
                "boolean exclusiveMinimum/exclusiveMaximum (draft-04 "
                "form) is not supported; use the numeric draft-06+ form"
            )
        if ex_lo is not None:
            ex = math.floor(ex_lo) + 1
            lo = ex if lo is None else max(lo, ex)
        if ex_hi is not None:
            ex = math.ceil(ex_hi) - 1
            hi = ex if hi is None else min(hi, ex)
        return int_range_ast(lo, hi)
    if t == "number":
        if any(k in schema for k in (
            "minimum", "maximum", "exclusiveMinimum", "exclusiveMaximum",
        )):
            import warnings

            # Float range enforcement needs decimal digit-DP the
            # automaton does not implement (outlines likewise skips
            # it) — generate unconstrained, but never silently.
            warnings.warn(
                "number schema bounds (minimum/maximum) are not "
                "enforced by guided decoding; use type 'integer' for "
                "enforced ranges",
            )
        return number_ast()
    if t == "boolean":
        return alt(literal("true"), literal("false"))
    if t == "null":
        return literal("null")
    if t == "array":
        item = schema.get("items", {"type": "string"})
        inner = schema_to_ast(item, ws)
        min_items = int(schema.get("minItems", 0))
        max_items = schema.get("maxItems")
        if min_items < 0 or (max_items is not None and int(max_items) < min_items):
            raise ValueError(
                f"invalid array bounds minItems={min_items} maxItems={max_items}"
            )
        follow = seq(ws, char(","), ws, inner)
        if max_items is not None:
            max_i = int(max_items)
            if max_i == 0:
                body = EPS
            elif min_items >= 1:
                body = seq(inner, bounded(follow, min_items - 1, max_i - 1))
            else:
                body = opt(seq(inner, bounded(follow, 0, max_i - 1)))
        elif min_items >= 1:
            body = seq(inner, *([follow] * (min_items - 1)), star(follow))
        else:
            body = opt(seq(inner, star(follow)))
        return seq(char("["), ws, body, ws, char("]"))
    raise ValueError(f"Unsupported schema: {schema!r}")


_MAX_OPTIONAL_PROPS = 8


def _object_ast(schema: Dict[str, Any], ws: Optional[Node] = None) -> Node:
    """Object with properties emitted in declaration order (outlines-
    compatible: the model must emit keys in schema order).

    JSON Schema semantics: only names listed in ``required`` are
    mandatory; an absent ``required`` means every property is optional.
    Optional properties anywhere in the order are supported by
    enumerating the presence subsets (bounded by ``_MAX_OPTIONAL_PROPS``
    to keep the automaton small)."""
    if ws is None:
        ws = WS
    props = schema.get("properties", {})
    required = set(schema.get("required", []))
    unknown = required - set(props)
    if unknown:
        raise ValueError(f"required names {sorted(unknown)} not in properties")

    members = []
    for name, sub in props.items():
        member = seq(json_string_literal(name), ws, char(":"), ws, schema_to_ast(sub, ws))
        members.append((name, member, name in required))

    if not members:
        return seq(char("{"), ws, char("}"))

    optional_count = sum(1 for _, _, is_req in members if not is_req)
    if optional_count > _MAX_OPTIONAL_PROPS:
        raise ValueError(
            f"object schema has {optional_count} optional properties; "
            f"at most {_MAX_OPTIONAL_PROPS} supported"
        )

    # Fast path: optional members form a suffix after >=1 required member
    # (every BCG schema) -> linear chain of optional comma-groups.
    flags = [is_req for _, _, is_req in members]
    suffix_form = flags[0] and not any(
        earlier is False and later is True for earlier, later in zip(flags, flags[1:])
    )
    if suffix_form:
        body = members[0][1]
        for _, member, is_required in members[1:]:
            group = seq(ws, char(","), ws, member)
            body = seq(body, group if is_required else opt(group))
        return seq(char("{"), ws, body, ws, char("}"))

    # General path: alternate over every valid presence subset, keeping
    # declaration order within each subset.
    optional_idx = [i for i, (_, _, is_req) in enumerate(members) if not is_req]
    bodies = []
    for mask in range(1 << len(optional_idx)):
        present = [
            m
            for i, (_, m, is_req) in enumerate(members)
            if is_req or (i in optional_idx and (mask >> optional_idx.index(i)) & 1)
        ]
        if not present:
            bodies.append(EPS)
            continue
        body = present[0]
        for member in present[1:]:
            body = seq(body, ws, char(","), ws, member)
        bodies.append(body)
    return seq(char("{"), ws, alt(*bodies), ws, char("}"))
