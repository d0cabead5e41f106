"""Regular-expression AST over the byte alphabet.

The schema compiler builds these nodes directly (no regex-string parsing),
and :mod:`bcg_tpu_torch.guided.dfa` lowers them Thompson-style to an NFA and
then a DFA.  The alphabet is bytes 0..255 so any tokenizer byte sequence
can be walked through the resulting automaton.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Tuple


class Node:
    """Base regex AST node."""

    def __add__(self, other: "Node") -> "Node":
        return seq(self, other)

    def __or__(self, other: "Node") -> "Node":
        return alt(self, other)


@dataclass(frozen=True)
class Epsilon(Node):
    pass


@dataclass(frozen=True)
class CharClass(Node):
    """Match one byte from ``chars``."""

    chars: FrozenSet[int]


@dataclass(frozen=True)
class Seq(Node):
    parts: Tuple[Node, ...]


@dataclass(frozen=True)
class Alt(Node):
    options: Tuple[Node, ...]


@dataclass(frozen=True)
class Star(Node):
    inner: Node


@dataclass(frozen=True)
class Bounded(Node):
    """Between ``min_count`` and ``max_count`` repetitions of ``inner``.

    A dedicated node (rather than a nested ``opt(seq(...))`` chain) keeps
    AST depth O(1), so deep bounded repetitions (e.g. ``maxLength: 500``)
    don't blow Python's recursion limit during NFA construction."""

    inner: Node
    min_count: int
    max_count: int


EPS = Epsilon()


def seq(*parts: Node) -> Node:
    flat = []
    for p in parts:
        if isinstance(p, Epsilon):
            continue
        if isinstance(p, Seq):
            flat.extend(p.parts)
        else:
            flat.append(p)
    if not flat:
        return EPS
    if len(flat) == 1:
        return flat[0]
    return Seq(tuple(flat))


def alt(*options: Node) -> Node:
    flat = []
    for o in options:
        if isinstance(o, Alt):
            flat.extend(o.options)
        else:
            flat.append(o)
    if len(flat) == 1:
        return flat[0]
    return Alt(tuple(flat))


def star(inner: Node) -> Node:
    return Star(inner)


def plus(inner: Node) -> Node:
    return seq(inner, Star(inner))


def opt(inner: Node) -> Node:
    return alt(inner, EPS)


def bounded(inner: Node, min_count: int, max_count: int) -> Node:
    if min_count < 0 or max_count < min_count:
        raise ValueError(f"bad repetition bounds [{min_count}, {max_count}]")
    if max_count == 0:
        return EPS
    return Bounded(inner, min_count, max_count)


def char(c: str) -> Node:
    b = c.encode("utf-8")
    return seq(*(CharClass(frozenset((x,))) for x in b))


def literal(s: str) -> Node:
    return seq(*(char(c) for c in s))


def char_set(chars: str) -> Node:
    out = set()
    for c in chars:
        b = c.encode("utf-8")
        if len(b) != 1:
            raise ValueError(f"char_set only supports single-byte chars, got {c!r}")
        out.add(b[0])
    return CharClass(frozenset(out))


def byte_range(lo: int, hi: int) -> Node:
    return CharClass(frozenset(range(lo, hi + 1)))


def digit_range(lo: int, hi: int) -> Node:
    """One decimal digit between lo and hi inclusive."""
    return CharClass(frozenset(range(0x30 + lo, 0x30 + hi + 1)))


DIGIT = digit_range(0, 9)
