"""A reader of HuggingFace ``tokenizer.json`` files that needs neither
``tokenizers`` nor ``transformers``, so a GPU host without them serves a
checkpoint's own tokenizer.

It runs the pipeline ``tokenizers`` runs for ``encode(text,
add_special_tokens=False)`` and ``decode(ids, skip_special_tokens=...)``:

1. added tokens are split out first — those with ``normalized: false``
   on the raw text, the rest on each remaining piece once the normalizer
   has run — leftmost-longest, with their ``single_word``, ``lstrip`` and
   ``rstrip`` flags;
2. the normalizer (none, NFC, ``Prepend``, ``Replace`` of a string,
   ``Sequence``);
3. the pre-tokenizer (``ByteLevel`` with and without its regex,
   ``Split`` on a regex, ``Isolated``; ``Metaspace`` with its prepend
   schemes; ``Sequence``);
4. the BPE model (``merges`` as strings or pairs, ``ignore_merges``,
   ``byte_fallback``, ``unk_token``, ``fuse_unk``), applying the lowest
   ranked pair first, leftmost on ties, as ``tokenizers`` does;
5. on decode, the decoder chain (``ByteLevel``, ``Metaspace``,
   ``Replace``, ``ByteFallback``, ``Fuse``, ``Strip``, ``Sequence``).

The split patterns of the GPT-2, Qwen2 and Llama-3 families use
``\\p{L}``, ``\\p{N}`` and Unicode ``\\s``, which Python's ``re`` lacks:
:func:`translate_regex` rewrites them into explicit character classes
built from :mod:`unicodedata` (``\\s`` as the Unicode ``White_Space``
set, which is what the Oniguruma engine of ``tokenizers`` matches, not
Python's ``str.isspace``).

A component this reader does not implement raises
``NotImplementedError`` naming it; nothing is approximated.
"""

from __future__ import annotations

import functools
import heapq
import re
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------- regexes
# Unicode White_Space (what Oniguruma's \s matches on UTF-8 text, and
# Rust's char::is_whitespace); Python's \s also takes U+001C..U+001F.
_WS_CODEPOINTS = (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
                  *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F, 0x205F, 0x3000)
_WS_SET = frozenset(chr(c) for c in _WS_CODEPOINTS)


def _esc(cp: int) -> str:
    return f"\\U{cp:08x}"


# The body of a character class matching White_Space.
_WHITE_SPACE = "".join(_esc(c) for c in _WS_CODEPOINTS)


def is_whitespace(ch: str) -> bool:
    return ch in _WS_SET


@functools.lru_cache(maxsize=None)
def _category_ranges() -> Dict[str, List[Tuple[int, int]]]:
    """``{general category: [(lo, hi), ...]}`` over every code point."""
    out: Dict[str, List[Tuple[int, int]]] = {}
    cat = unicodedata.category
    prev, start = None, 0
    for cp in range(0x110000):
        c = cat(chr(cp))
        if c != prev:
            if prev is not None:
                out.setdefault(prev, []).append((start, cp - 1))
            prev, start = c, cp
    out.setdefault(prev, []).append((start, 0x10FFFF))
    return out


@functools.lru_cache(maxsize=None)
def _property_class(name: str) -> str:
    """The body of a character class (no brackets) for ``\\p{name}``: a
    one-letter major category (L, N, P, ...) or a two-letter one (Lu,
    Nd, ...)."""
    ranges = _category_ranges()
    cats = [c for c in ranges if c == name or (len(name) == 1 and c[0] == name)]
    if not cats or len(name) not in (1, 2):
        raise NotImplementedError(f"tokenizer regex: Unicode property \\p{{{name}}}")
    merged: List[Tuple[int, int]] = sorted(r for c in cats for r in ranges[c])
    body = []
    lo, hi = merged[0]
    for a, b in merged[1:]:
        if a == hi + 1:
            hi = b
        else:
            body.append((lo, hi))
            lo, hi = a, b
    body.append((lo, hi))
    return "".join(_esc(a) if a == b else f"{_esc(a)}-{_esc(b)}" for a, b in body)


_UNSUPPORTED_ESCAPES = set("wWbBhHXRKGAzZ")


def translate_regex(pattern: str) -> str:
    """Rewrite an Oniguruma pattern of a ``tokenizer.json`` into Python
    ``re`` syntax: ``\\p{X}``/``\\P{X}`` become explicit classes,
    ``\\s``/``\\S`` the Unicode White_Space set.  Escapes whose meaning
    differs between the two engines raise ``NotImplementedError``."""
    out: List[str] = []
    i, n = 0, len(pattern)
    in_class = False
    class_start = -1
    while i < n:
        ch = pattern[i]
        if ch == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if nxt in "pP" and i + 2 < n and pattern[i + 2] == "{":
                end = pattern.index("}", i + 3)
                body = _property_class(pattern[i + 3:end])
                if nxt == "P":
                    if in_class:
                        raise NotImplementedError(
                            "tokenizer regex: \\P{...} inside a character class")
                    out.append(f"[^{body}]")
                else:
                    out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt == "s":
                out.append(_WHITE_SPACE if in_class else f"[{_WHITE_SPACE}]")
                i += 2
                continue
            if nxt == "S":
                if in_class:
                    raise NotImplementedError("tokenizer regex: \\S inside a character class")
                out.append(f"[^{_WHITE_SPACE}]")
                i += 2
                continue
            if nxt in _UNSUPPORTED_ESCAPES:
                raise NotImplementedError(f"tokenizer regex: escape \\{nxt}")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if in_class:
            if ch == "[":
                raise NotImplementedError("tokenizer regex: nested character class")
            if ch == "]" and i > class_start:
                in_class = False
            out.append(ch)
            i += 1
            continue
        if ch == "[":
            in_class = True
            out.append(ch)
            i += 1
            if i < n and pattern[i] == "^":
                out.append("^")
                i += 1
            # A ']' right after '[' or '[^' is a literal member.
            class_start = i + 1
            continue
        out.append(ch)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=None)
def compile_regex(pattern: str) -> "re.Pattern[str]":
    return re.compile(translate_regex(pattern))


def _split(text: str, matches: List[Tuple[int, int]], behavior: str) -> List[Tuple[int, int]]:
    """``tokenizers``' ``NormalizedString::split``: the (start, end)
    pieces of ``text`` for the delimiter ``matches`` under ``behavior``
    (``Isolated``: every match and every gap its own piece;
    ``MergedWithNext``: a match joins the piece after it).  Empty pieces
    are dropped by the caller."""
    pieces: List[Tuple[Tuple[int, int], bool]] = []
    prev = 0
    for s, e in matches:
        if prev != s:
            pieces.append(((prev, s), False))
        pieces.append(((s, e), True))
        prev = e
    if prev != len(text):
        pieces.append(((prev, len(text)), False))
    if behavior == "Isolated":
        return [off for off, _ in pieces]
    if behavior != "MergedWithNext":
        raise NotImplementedError(f"tokenizer split behavior: {behavior}")
    acc: List[List[int]] = []
    prev_match = False
    for (s, e), m in reversed(pieces):
        if m and not prev_match and acc:
            acc[-1][0] = s
        else:
            acc.append([s, e])
        prev_match = m
    acc.reverse()
    return [(s, e) for s, e in acc]


# ------------------------------------------------------------- byte level
@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> printable character table of ``ByteLevel``."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=None)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


# The ByteLevel pre-tokenizer's own split pattern (GPT-2's).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

# A piece of text in the pipeline: its string, and whether it starts at
# offset 0 of the original text (Metaspace's "first" prepend scheme).
Piece = Tuple[str, bool]


# ------------------------------------------------------------ normalizers
def build_normalizer(spec: Optional[Dict]) -> Optional[Callable[[str], str]]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "NFC":
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        content = spec["content"]
        pat = spec["pattern"]
        if "String" not in pat:
            raise NotImplementedError(f"tokenizer normalizer Replace pattern: {sorted(pat)}")
        lit = pat["String"]
        return lambda s: s.replace(lit, content)
    if kind == "Sequence":
        parts = [build_normalizer(n) for n in spec.get("normalizers", [])]
        parts = [p for p in parts if p is not None]

        def seq(s: str) -> str:
            for p in parts:
                s = p(s)
            return s
        return seq
    raise NotImplementedError(f"tokenizer normalizer: {kind}")


# --------------------------------------------------------- pre-tokenizers
PreTok = Callable[[List[Piece]], List[Piece]]


def _regex_spans(rx: "re.Pattern[str]", text: str) -> List[Tuple[int, int]]:
    return [m.span() for m in rx.finditer(text) if m.end() > m.start()]


def _split_pieces(pieces: List[Piece], fn: Callable[[str], List[Tuple[int, int]]]) -> List[Piece]:
    out: List[Piece] = []
    for text, at_start in pieces:
        for s, e in fn(text):
            if e > s:
                out.append((text[s:e], at_start and s == 0))
    return out


def build_pre_tokenizer(spec: Optional[Dict]) -> Optional[PreTok]:
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        prefix = bool(spec.get("add_prefix_space", False))
        use_regex = bool(spec.get("use_regex", True))
        rx = compile_regex(GPT2_PATTERN) if use_regex else None
        table = bytes_to_unicode()

        def byte_level(pieces: List[Piece]) -> List[Piece]:
            out: List[Piece] = []
            for text, at_start in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                parts = (_split(text, _regex_spans(rx, text), "Isolated") if rx is not None
                         else [(0, len(text))])
                for s, e in parts:
                    if e > s:
                        mapped = "".join(table[b] for b in text[s:e].encode("utf-8"))
                        out.append((mapped, at_start and s == 0))
            return out
        return byte_level
    if kind == "Split":
        pattern = spec["pattern"]
        if "Regex" not in pattern:
            raise NotImplementedError(f"tokenizer Split pattern: {sorted(pattern)}")
        if spec.get("behavior", "Isolated") != "Isolated" or spec.get("invert", False):
            raise NotImplementedError(
                f"tokenizer Split behavior: {spec.get('behavior')}, invert "
                f"{spec.get('invert')}")
        rx = compile_regex(pattern["Regex"])
        return lambda pieces: _split_pieces(
            pieces, lambda t: _split(t, _regex_spans(rx, t), "Isolated"))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        if "prepend_scheme" in spec:
            scheme = spec["prepend_scheme"]
        else:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        if scheme not in ("always", "first", "never"):
            raise NotImplementedError(f"tokenizer Metaspace prepend_scheme: {scheme}")
        do_split = bool(spec.get("split", True))

        def metaspace(pieces: List[Piece]) -> List[Piece]:
            out: List[Piece] = []
            for text, at_start in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and at_start)
                ):
                    text = rep + text
                if not do_split:
                    out.append((text, at_start))
                    continue
                spans = [(i, i + len(rep)) for i in range(len(text)) if text.startswith(rep, i)]
                for s, e in _split(text, spans, "MergedWithNext"):
                    if e > s:
                        out.append((text[s:e], at_start and s == 0))
            return out
        return metaspace
    if kind == "Sequence":
        parts = [build_pre_tokenizer(p) for p in spec.get("pretokenizers", [])]
        parts = [p for p in parts if p is not None]

        def seq(pieces: List[Piece]) -> List[Piece]:
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    raise NotImplementedError(f"tokenizer pre_tokenizer: {kind}")


# -------------------------------------------------------------- decoders
Decoder = Callable[[List[str]], List[str]]


def build_decoder(spec: Optional[Dict]) -> Optional[Decoder]:
    """``tokens -> tokens`` (``decode_chain``); the text is their join."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "ByteLevel":
        back = _unicode_to_bytes()

        def byte_level(tokens: List[str]) -> List[str]:
            data = bytearray()
            for t in tokens:
                try:
                    data += bytes(back[c] for c in t)
                except KeyError:
                    data += t.encode("utf-8")
            return [data.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        if "prepend_scheme" in spec:
            strip_first = spec["prepend_scheme"] != "never"
        else:
            strip_first = bool(spec.get("add_prefix_space", True))

        def metaspace(tokens: List[str]) -> List[str]:
            return [
                "".join(("" if i == 0 and strip_first else " ") if c == rep else c
                        for c in t)
                for i, t in enumerate(tokens)
            ]
        return metaspace
    if kind == "Replace":
        content = spec["content"]
        pat = spec["pattern"]
        if "String" not in pat:
            raise NotImplementedError(f"tokenizer decoder Replace pattern: {sorted(pat)}")
        lit = pat["String"]
        return lambda tokens: [t.replace(lit, content) for t in tokens]
    if kind == "ByteFallback":
        def byte_fallback(tokens: List[str]) -> List[str]:
            out: List[str] = []
            pending = bytearray()

            def flush() -> None:
                if pending:
                    try:
                        out.append(bytes(pending).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("�" for _ in pending)
                    pending.clear()
            for t in tokens:
                b = None
                if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                    try:
                        b = int(t[3:5], 16)
                    except ValueError:
                        b = None
                if b is not None:
                    pending.append(b)
                else:
                    flush()
                    out.append(t)
            flush()
            return out
        return byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        content, start, stop = spec["content"], int(spec["start"]), int(spec["stop"])

        def strip(tokens: List[str]) -> List[str]:
            out = []
            for t in tokens:
                a = 0
                while a < start and a < len(t) and t[a] == content:
                    a += 1
                b = 0
                while b < stop and b < len(t) - a and t[len(t) - 1 - b] == content:
                    b += 1
                out.append(t[a:len(t) - b])
            return out
        return strip
    if kind == "Sequence":
        parts = [build_decoder(d) for d in spec.get("decoders", [])]
        parts = [p for p in parts if p is not None]

        def seq(tokens: List[str]) -> List[str]:
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    raise NotImplementedError(f"tokenizer decoder: {kind}")


# ----------------------------------------------------------------- BPE
class BPE:
    """The BPE model of a ``tokenizer.json`` (``"type": "BPE"``)."""

    def __init__(self, spec: Dict):
        if spec.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model: {spec.get('type')}")
        if spec.get("dropout") not in (None, 0, 0.0):
            raise NotImplementedError("tokenizer BPE: dropout")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer BPE: {key}")
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.vocab_r: Dict[int, str] = {i: t for t, i in self.vocab.items()}
        self.unk_token: Optional[str] = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            if isinstance(m, str):
                parts = m.split(" ")
                if len(parts) != 2:
                    raise ValueError(f"tokenizer BPE: bad merge {m!r}")
                a, b = parts
            else:
                a, b = m
            try:
                pair = (self.vocab[a], self.vocab[b])
                new_id = self.vocab[a + b]
            except KeyError as exc:
                raise ValueError(f"tokenizer BPE: merge {a!r} {b!r} outside the vocab") from exc
            self.merges[pair] = (rank, new_id)
        self._cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[Tuple[int, int]]:
        """(id, byte length) of each initial symbol of ``word``."""
        out: List[Tuple[int, int]] = []
        unk: Optional[List[int]] = None
        for ch in word:
            blen = len(ch.encode("utf-8"))
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    out.append((unk[0], unk[1]))
                    unk = None
                out.append((tid, blen))
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    # Pending unknowns wait for the next vocab hit, as in
                    # tokenizers' merge_word.
                    out.extend((i, 1) for i in ids)
                    continue
            if self.unk_token is not None:
                unk_id = self.vocab[self.unk_token]
                if unk is not None and self.fuse_unk:
                    unk[1] += blen
                else:
                    if unk is not None:
                        out.append((unk[0], unk[1]))
                    unk = [unk_id, blen]
        if unk is not None:
            out.append((unk[0], unk[1]))
        return out

    def tokenize(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self.ignore_merges and word in self.vocab:
            ids = [self.vocab[word]]
        else:
            ids = self._merge(self._symbols(word))
        if len(self._cache) < 200_000:
            self._cache[word] = ids
        return ids

    def _merge(self, symbols: List[Tuple[int, int]]) -> List[int]:
        n = len(symbols)
        c = [s[0] for s in symbols]
        alive = [True] * n
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1:] = [-1] if n else []
        merges = self.merges
        heap: List[Tuple[int, int, int]] = []
        for i in range(n - 1):
            m = merges.get((c[i], c[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            rank, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((c[pos], c[right]))
            if m is None or m[1] != new_id:
                continue
            c[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((c[pos], c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


# ---------------------------------------------------------- added tokens
class AddedToken:
    __slots__ = ("id", "content", "single_word", "lstrip", "rstrip", "normalized", "special")

    def __init__(self, id: int, content: str, single_word=False, lstrip=False,
                 rstrip=False, normalized=True, special=False):
        self.id = int(id)
        self.content = content
        self.single_word = bool(single_word)
        self.lstrip = bool(lstrip)
        self.rstrip = bool(rstrip)
        self.normalized = bool(normalized)
        self.special = bool(special)

    @classmethod
    def from_json(cls, row: Dict, id: Optional[int] = None) -> "AddedToken":
        return cls(row["id"] if id is None else id, row["content"],
                   row.get("single_word", False), row.get("lstrip", False),
                   row.get("rstrip", False), row.get("normalized", not row.get("special", False)),
                   row.get("special", False))

    def flags(self) -> Tuple:
        return (self.content, self.single_word, self.lstrip, self.rstrip,
                self.normalized, self.special)


def add_tokens(added: Dict[int, AddedToken], tokens: Sequence[AddedToken],
               model_vocab: Dict[str, int]) -> None:
    """Register ``tokens`` into ``added`` (id -> token) with the ids
    ``tokenizers`` gives them — not the ids a file states: a content
    already added or in the model vocabulary keeps that id, a new one
    takes the next free id past the model vocabulary (``AddedVocabulary::
    add_tokens``).  A re-added content replaces the token's flags."""
    by_content = {t.content: t.id for t in added.values()}
    n_model = len(model_vocab)
    for tok in tokens:
        if not tok.content:
            continue
        tid = by_content.get(tok.content, model_vocab.get(tok.content))
        if tid is None:
            top = max(added) if added else None
            tid = n_model if top is None or (top < n_model and n_model) else top + 1
        tok.id = tid
        added[tid] = tok
        by_content[tok.content] = tid


# Symbols (So) with the Other_Alphabetic property: circled, parenthesized
# and squared Latin letters.
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169),
                       (0x1F170, 0x1F189))


def _is_word_char(ch: str) -> bool:
    """Unicode ``\\w`` of the Rust ``regex`` crate, which ``tokenizers``'
    single-word check uses: Alphabetic, marks, decimal digits, connector
    punctuation and the join controls (not Python's ``str.isalnum``,
    which also takes ``²`` and ``½``)."""
    cat = unicodedata.category(ch)
    if cat[0] in "LM" or cat in ("Nd", "Nl", "Pc") or ch in "\u200c\u200d":
        return True
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _ALPHABETIC_SYMBOLS)


class _Matcher:
    """Leftmost-longest matching of a set of added tokens (the
    Aho-Corasick ``LeftmostLongest`` search of ``tokenizers``)."""

    def __init__(self, tokens: Sequence[Tuple[str, AddedToken]]):
        self.by_first: Dict[str, List[Tuple[str, AddedToken]]] = {}
        for pat, tok in tokens:
            if pat:
                self.by_first.setdefault(pat[0], []).append((pat, tok))
        for lst in self.by_first.values():
            lst.sort(key=lambda pt: -len(pt[0]))

    def split(self, text: str) -> List[Tuple[int, int, Optional[AddedToken]]]:
        """``tokenizers``' ``find_matches``: (start, end, token or None)
        pieces covering ``text``."""
        if not self.by_first:
            return [(0, len(text), None)]
        out: List[Tuple[int, int, Optional[AddedToken]]] = []
        start_offset = 0
        i, n = 0, len(text)
        while i < n:
            cands = self.by_first.get(text[i])
            hit = None
            if cands:
                for pat, tok in cands:
                    if text.startswith(pat, i):
                        hit = (pat, tok)
                        break
            if hit is None:
                i += 1
                continue
            pat, tok = hit
            start, stop = i, i + len(pat)
            i = stop
            if tok.single_word:
                start_space = start == 0 or not _is_word_char(text[start - 1])
                stop_space = stop == n or not _is_word_char(text[stop])
                if not (start_space and stop_space):
                    continue
            if tok.lstrip:
                j = start
                while j > 0 and is_whitespace(text[j - 1]):
                    j -= 1
                start = max(j, start_offset)
            if tok.rstrip:
                # The search resumes at the match's own end, as the
                # Aho-Corasick iterator does, not past the stripped spaces.
                while stop < n and is_whitespace(text[stop]):
                    stop += 1
            if start_offset < start:
                out.append((start_offset, start, None))
            out.append((start, stop, tok))
            start_offset = stop
        if start_offset != n:
            out.append((start_offset, n, None))
        return out


# ------------------------------------------------------------ tokenizer
class TokenizerJson:
    """The ``encode``/``decode`` of one ``tokenizer.json`` (parsed dict),
    plus the added tokens a loader registers on top (``extra_added``, in
    order, after the file's own)."""

    def __init__(self, spec: Dict, extra_added: Sequence[AddedToken] = (),
                 pre_tokenizer_override: Optional[Dict] = None):
        for key in ("truncation", "padding"):
            if spec.get(key):
                raise NotImplementedError(f"tokenizer.json {key}")
        self.spec = spec
        self.model = BPE(spec["model"])
        self.normalizer = build_normalizer(spec.get("normalizer"))
        pre = pre_tokenizer_override if pre_tokenizer_override is not None else spec.get(
            "pre_tokenizer")
        self.pre_tokenizer = build_pre_tokenizer(pre)
        self.decoder = build_decoder(spec.get("decoder"))
        self.added: Dict[int, AddedToken] = {}
        add_tokens(self.added, [AddedToken.from_json(r) for r in spec.get("added_tokens", [])],
                   self.model.vocab)
        add_tokens(self.added, extra_added, self.model.vocab)
        self.added_by_content = {t.content: t for t in self.added.values()}
        self.special_contents = {t.content for t in self.added.values() if t.special}
        raw = [(t.content, t) for t in self.added.values() if not t.normalized]
        norm = [((self.normalizer(t.content) if self.normalizer else t.content), t)
                for t in self.added.values() if t.normalized]
        self._raw_matcher = _Matcher(raw)
        self._norm_matcher = _Matcher(norm)

    def vocab(self) -> Dict[str, int]:
        """Token -> id over the model vocabulary and the added tokens."""
        out = dict(self.model.vocab)
        out.update({t.content: t.id for t in self.added.values()})
        return out

    def id_to_token(self, tid: int) -> Optional[str]:
        tok = self.added.get(tid)
        if tok is not None:
            return tok.content
        return self.model.vocab_r.get(tid)

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for s, e, tok in self._raw_matcher.split(text):
            if tok is not None:
                ids.append(tok.id)
                continue
            piece = text[s:e]
            if not piece:
                continue
            if self.normalizer is not None:
                piece = self.normalizer(piece)
            for s2, e2, tok2 in self._norm_matcher.split(piece):
                if tok2 is not None:
                    ids.append(tok2.id)
                    continue
                sub = piece[s2:e2]
                if not sub:
                    continue
                pieces: List[Piece] = [(sub, s == 0 and s2 == 0)]
                if self.pre_tokenizer is not None:
                    pieces = self.pre_tokenizer(pieces)
                for word, _ in pieces:
                    ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool) -> str:
        tokens: List[str] = []
        for tid in ids:
            tok = self.id_to_token(int(tid))
            if tok is None:
                continue
            if skip_special_tokens and tok in self.special_contents:
                continue
            tokens.append(tok)
        if self.decoder is None:
            return " ".join(tokens)
        return "".join(self.decoder(tokens))
