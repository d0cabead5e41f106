"""Textual regex -> regex AST, for JSON-schema ``pattern`` strings.

The reference's guided decoding (vLLM ``GuidedDecodingParams(json=...)``
via outlines-style compilation) accepts ``pattern`` on string schemas;
this parser closes that sub-gap for the TPU guided pipeline.  The
supported subset is the practical outlines-compatible core:

* literals (printable ASCII), ``.`` (any string-content char)
* escapes ``\\d \\D \\w \\W \\s \\S``, ``\\n \\t \\r``, and identity
  escapes of any printable non-alphanumeric ASCII char (``\\" \\- \\!``
  ... — the ECMA convention pattern authors expect)
* character classes ``[abc]``, ranges ``[a-z0-9]``, negation ``[^...]``
  (complement within printable ASCII + ``\\n\\t\\r``)
* quantifiers ``* + ?`` and ``{m} {m,} {m,n}``
* alternation ``|`` and groups ``(...)`` / ``(?:...)``
* ``^`` / ``$`` ONLY at the very ends (whole-string semantics — the
  outlines convention for schema patterns; mid-pattern anchors are
  rejected loudly rather than silently mis-handled)

Semantics are ANCHORED: the pattern must describe the whole string
value (matching outlines; note the JSON-Schema spec itself says
unanchored *search*, so authors who rely on that nuance must anchor
explicitly — a documented, loud divergence shared with the reference's
own toolchain).
"""

from __future__ import annotations

from typing import FrozenSet

from bcg_tpu_torch.guided.regex_ast import (
    CharClass,
    Node,
    alt,
    bounded,
    opt,
    plus,
    seq,
    star,
)

# The string VALUE alphabet: printable ASCII plus the three control
# chars the JSON emitter can escape (schema_compiler's string policy).
_VALUE_BYTES: FrozenSet[int] = frozenset(range(0x20, 0x7F)) | {0x09, 0x0A, 0x0D}

_DIGITS = frozenset(range(0x30, 0x3A))
_WORD = (frozenset(range(0x41, 0x5B)) | frozenset(range(0x61, 0x7B))
         | _DIGITS | {0x5F})
_SPACE = {0x20, 0x09, 0x0A, 0x0D}

_META = set("\\^$.|?*+()[]{}")


class PatternError(ValueError):
    """Unsupported or malformed ``pattern`` regex."""


class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.i = 0

    # ------------------------------------------------------------- utils
    def peek(self) -> str:
        return self.text[self.i] if self.i < len(self.text) else ""

    def take(self) -> str:
        c = self.peek()
        self.i += 1
        return c

    def fail(self, msg: str) -> "PatternError":
        return PatternError(
            f"pattern {self.text!r} at position {self.i}: {msg}"
        )

    # ----------------------------------------------------------- grammar
    def parse(self) -> Node:
        if self.peek() == "^":
            self.take()
        node = self.alternation()
        if self.i < len(self.text):
            raise self.fail(f"unexpected {self.peek()!r}")
        return node

    def alternation(self) -> Node:
        options = [self.sequence()]
        while self.peek() == "|":
            self.take()
            options.append(self.sequence())
        return alt(*options)

    def sequence(self) -> Node:
        parts = []
        while True:
            c = self.peek()
            if c in ("", "|", ")"):
                break
            if c == "$":
                # Accept only as the final character of the pattern.
                if self.i == len(self.text) - 1:
                    self.take()
                    break
                raise self.fail("'$' is only supported at the end")
            if c == "^":
                raise self.fail("'^' is only supported at the start")
            parts.append(self.quantified())
        return seq(*parts)

    def quantified(self) -> Node:
        atom = self.atom()
        c = self.peek()
        if c == "*":
            self.take()
            atom = star(atom)
        elif c == "+":
            self.take()
            atom = plus(atom)
        elif c == "?":
            self.take()
            atom = opt(atom)
        elif c == "{":
            atom = self.braces(atom)
        else:
            return atom
        # ONE quantifier per atom: 'a+?' (lazy) or 'a**' would otherwise
        # silently parse as stacked greedy quantifiers with a DIFFERENT
        # accepted language than ECMA (a+? must match at least one 'a';
        # opt(plus(a)) matches the empty string) — reject loudly.
        if self.peek() in ("*", "+", "?", "{"):
            raise self.fail(
                "lazy/possessive or stacked quantifiers are not supported"
            )
        return atom

    def braces(self, atom: Node) -> Node:
        start = self.i
        self.take()  # '{'
        body = ""
        while self.peek() not in ("}", ""):
            body += self.take()
        if self.peek() != "}":
            raise self.fail("unterminated '{'")
        self.take()
        try:
            if "," not in body:
                m = n = int(body)
            else:
                lo_s, hi_s = body.split(",", 1)
                m = int(lo_s)
                n = None if hi_s.strip() == "" else int(hi_s)
        except ValueError:
            self.i = start
            raise self.fail(f"malformed quantifier {{{body}}}")
        if m < 0 or (n is not None and n < m):
            self.i = start
            raise self.fail(f"invalid bounds {{{body}}}")
        if n is None:  # {m,} = m copies then *
            return seq(*([atom] * m), star(atom))
        return bounded(atom, m, n)

    def atom(self) -> Node:
        c = self.take()
        if c == "(":
            if self.peek() == "?":
                self.take()
                if self.take() != ":":
                    raise self.fail("only (?:...) groups are supported")
            inner = self.alternation()
            if self.take() != ")":
                raise self.fail("unterminated '('")
            return inner
        if c == "[":
            return self.char_class()
        if c == ".":
            # ECMA '.' excludes line terminators.
            return CharClass(_VALUE_BYTES - {0x0A, 0x0D})
        if c == "\\":
            return self.escape()
        if c in _META:
            raise self.fail(f"unexpected metacharacter {c!r}")
        if ord(c) not in _VALUE_BYTES:
            # Non-ASCII literals would need UTF-8 byte sequences; the
            # string alphabet is ASCII by design (schema_compiler) —
            # reject loudly instead of emitting broken byte classes.
            raise self.fail(f"non-ASCII literal {c!r} is not supported")
        return CharClass(frozenset({ord(c)}))

    def escape(self) -> Node:
        c = self.take()
        if c == "":
            raise self.fail("dangling '\\'")
        named = {
            "d": _DIGITS, "D": _VALUE_BYTES - _DIGITS,
            "w": _WORD, "W": _VALUE_BYTES - _WORD,
            "s": frozenset(_SPACE), "S": _VALUE_BYTES - frozenset(_SPACE),
        }
        if c in named:
            return CharClass(frozenset(named[c]))
        controls = {"n": 0x0A, "t": 0x09, "r": 0x0D}
        if c in controls:
            return CharClass(frozenset({controls[c]}))
        # Identity escapes: ECMA-262 lets any non-word punctuation be
        # escaped to itself, and pattern authors habitually write \" or
        # \/ even where the raw char would do.  Accept every printable
        # non-alphanumeric ASCII char (covers _META and '-/]').
        if ord(c) in _VALUE_BYTES and not c.isalnum() and c.isprintable():
            return CharClass(frozenset({ord(c)}))
        raise self.fail(f"unsupported escape \\{c}")

    def _class_atom(self) -> FrozenSet[int]:
        """One class member: an escape (possibly a multi-char named
        class) or a literal char, as a byte set."""
        c = self.peek()
        if c == "\\":
            self.take()
            node = self.escape()
            return frozenset(node.chars)  # type: ignore[attr-defined]
        if ord(c) not in _VALUE_BYTES:
            raise self.fail(f"non-ASCII class member {c!r} is not supported")
        self.take()
        return frozenset({ord(c)})

    def char_class(self) -> Node:
        negate = False
        if self.peek() == "^":
            self.take()
            negate = True
        members: set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c == "":
                raise self.fail("unterminated '['")
            if c == "]" and not first:
                self.take()
                break
            first = False
            atom_set = self._class_atom()
            # Range: any SINGLE-char atom (literal or escaped, e.g.
            # '\t-\r') may start one; named multi-char classes cannot.
            if (len(atom_set) == 1 and self.peek() == "-"
                    and self.text[self.i + 1: self.i + 2] not in ("]", "")):
                self.take()  # '-'
                hi_set = self._class_atom()
                if len(hi_set) != 1:
                    raise self.fail("range bound must be a single char")
                lo_b = next(iter(atom_set))
                hi_b = next(iter(hi_set))
                if hi_b < lo_b:
                    raise self.fail(f"reversed range {chr(lo_b)}-{chr(hi_b)}")
                members |= set(range(lo_b, hi_b + 1))
            else:
                members |= atom_set
        if negate:
            members = set(_VALUE_BYTES) - members
        dropped = members - set(_VALUE_BYTES)
        if dropped:
            raise self.fail(
                f"class members outside the ASCII string alphabet: "
                f"{sorted(dropped)[:5]}"
            )
        if not members:
            raise self.fail("empty character class")
        return CharClass(frozenset(members))


def parse_pattern(pattern: str) -> Node:
    """Parse a JSON-schema ``pattern`` regex into a VALUE-level AST
    (chars are the raw string-value bytes; JSON escaping is applied by
    :func:`json_escape_transform` before embedding in the grammar)."""
    return _Parser(pattern).parse()


# JSON string emission: chars a JSON string cannot carry raw, mapped to
# their escape sequences.
_NEEDS_ESCAPE = {
    0x22: b'\\"', 0x5C: b"\\\\",
    0x0A: b"\\n", 0x09: b"\\t", 0x0D: b"\\r",
}


def json_escape_transform(node: Node) -> Node:
    """Rewrite a value-level AST into the JSON-emission alphabet: any
    char that must be escaped inside a JSON string becomes its
    ``\\x`` two-byte escape sequence; everything else passes through."""
    from bcg_tpu_torch.guided import regex_ast as ra

    if isinstance(node, ra.Epsilon):
        return node
    if isinstance(node, ra.CharClass):
        plain = frozenset(b for b in node.chars if b not in _NEEDS_ESCAPE)
        options = []
        if plain:
            options.append(CharClass(plain))
        for b in sorted(set(node.chars) & set(_NEEDS_ESCAPE)):
            esc = _NEEDS_ESCAPE[b]
            options.append(seq(*(CharClass(frozenset({e})) for e in esc)))
        return alt(*options)
    if isinstance(node, ra.Seq):
        return seq(*(json_escape_transform(p) for p in node.parts))
    if isinstance(node, ra.Alt):
        return alt(*(json_escape_transform(p) for p in node.options))
    if isinstance(node, ra.Star):
        return star(json_escape_transform(node.inner))
    if isinstance(node, ra.Bounded):
        return bounded(
            json_escape_transform(node.inner), node.min_count, node.max_count
        )
    raise PatternError(f"unknown AST node {type(node).__name__}")
