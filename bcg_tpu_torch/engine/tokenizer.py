"""Tokenizers.

The engine needs three things from a tokenizer: encode/decode, a byte
representation of every vocabulary entry (to build token DFAs), and the
special ids.  Two implementations:

* :class:`ByteTokenizer` — hermetic byte-level tokenizer (token i =
  byte i, plus specials), used by the tiny-test and bench models.
* :class:`HFTokenizer` — wraps a local HuggingFace tokenizer for real
  checkpoints (Qwen3 / Llama-3 / Mistral), recovering token byte strings
  from the GPT-2 byte-unicode table or SentencePiece metaspace.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class Tokenizer:
    """Protocol: subclasses provide the attributes/methods below."""

    vocab_size: int
    eos_id: int
    pad_id: int
    vocab_id: int  # stable id for the guided-decoding schema cache

    def encode(self, text: str) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def token_bytes(self) -> List[bytes]:
        """Byte string of every token id (specials map to b'')."""
        raise NotImplementedError


class ByteTokenizer(Tokenizer):
    """Token i == byte i for i < 256; then specials.  Vocabulary is padded
    to ``vocab_size`` (model embedding tables like multiples of 128)."""

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 260
        self.vocab_size = vocab_size
        self.eos_id = 256
        self.bos_id = 257
        self.pad_id = 258
        self.vocab_id = 1  # reserved id for the byte vocabulary

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def token_bytes(self) -> List[bytes]:
        out = [bytes([i]) for i in range(256)]
        out += [b""] * (self.vocab_size - 256)
        return out


# GPT-2 byte<->unicode table (used by Qwen/Llama BPE vocabs).
def _gpt2_byte_decoder() -> dict:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


class HFTokenizer(Tokenizer):
    """Adapter over ``transformers.AutoTokenizer`` loaded from a local
    path (this build environment has no network egress; checkpoints must
    already be on disk)."""

    def __init__(self, path: str, vocab_id: Optional[int] = None):
        from transformers import AutoTokenizer

        # local_files_only: a bare name would otherwise trigger ~minutes of
        # network retries in this zero-egress environment before failing.
        self.tk = AutoTokenizer.from_pretrained(
            path, trust_remote_code=True, local_files_only=True
        )
        self.vocab_size = len(self.tk)
        self.eos_id = self.tk.eos_token_id
        self.pad_id = (
            self.tk.pad_token_id if self.tk.pad_token_id is not None else self.eos_id
        )
        if vocab_id is None:
            # Distinct HF vocabularies must not share a guided-DFA cache
            # slot (the cache key is (vocab_id, vocab_len) —
            # guided/processor.py): derive a stable id from the local
            # checkpoint path.  2..2**30 keeps clear of the reserved
            # ByteTokenizer id 1.
            import zlib

            vocab_id = 2 + (zlib.crc32(os.path.abspath(path).encode()) % (1 << 30))
        self.vocab_id = vocab_id
        self._byte_decoder = _gpt2_byte_decoder()
        self._byte_level = self._detect_byte_level()
        # Added tokens (special or not) are stored as RAW strings in the
        # vocab, never byte-encoded — they must bypass the byte table.
        added = getattr(self.tk, "added_tokens_decoder", {}) or {}
        self._added_ids = set(added)
        # Control tokens are marked special in tokenizer.json's
        # added_tokens (AddedToken.special) — transformers only surfaces
        # the config-registered ones via all_special_ids, but ALL of them
        # must be forbidden in guided decoding (b'' in the DFA).
        self._special_ids = set(self.tk.all_special_ids) | {
            tid for tid, tok in added.items() if getattr(tok, "special", False)
        }

    def _detect_byte_level(self) -> bool:
        """True for GPT-2-style byte-level-BPE vocabs (Qwen, Llama-3,
        GPT-2), False for true SentencePiece vocabs (Llama-2, Mistral
        pre-tekken).

        The vocab family decides how token strings map to bytes; checking
        string CONTENT per token (the old heuristic: "has a metaspace →
        SentencePiece") mis-decodes any byte-BPE vocab entry that happens
        to contain a literal ``▁`` — e.g. an added token — corrupting the
        token DFA for every schema.  Introspect the backend tokenizer's
        declared pre-tokenizer/decoder instead; fall back to a whole-vocab
        scan for the byte-level space marker ``Ġ`` (U+0120), which every
        byte-BPE vocab contains and no SentencePiece vocab does.
        """
        import json as _json

        backend = getattr(self.tk, "backend_tokenizer", None)
        if backend is not None:
            try:
                spec = _json.loads(backend.to_str())

                def _types(node):
                    if not isinstance(node, dict):
                        return set()
                    out = {node.get("type")}
                    for sub in node.get("pretokenizers", []) or []:
                        out |= _types(sub)
                    for sub in node.get("decoders", []) or []:
                        out |= _types(sub)
                    return out

                kinds = _types(spec.get("pre_tokenizer") or {})
                kinds |= _types(spec.get("decoder") or {})
                kinds |= {(spec.get("model") or {}).get("type")}
                if "ByteLevel" in kinds:
                    return True
                if "Metaspace" in kinds:
                    return False
            except (ValueError, TypeError, KeyError, AttributeError):
                # Malformed/unexpected backend spec JSON: fall through to
                # the whole-vocab scan below.
                pass
        return any("Ġ" in t for t in self.tk.get_vocab())

    def encode(self, text: str) -> List[int]:
        return self.tk.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=True)

    def _token_to_bytes(self, token: str, tid: int) -> bytes:
        if tid in self._special_ids:
            return b""
        if tid in self._added_ids:
            # Non-special added token: raw string, whatever the family.
            return token.encode("utf-8")
        if self._byte_level:
            # GPT-2 byte-unicode table (fix vs round 1: byte-level is
            # decided per VOCAB, so a literal metaspace inside a byte-BPE
            # token can no longer divert it to the SentencePiece branch).
            try:
                return bytes(self._byte_decoder[ch] for ch in token)
            except KeyError:
                return token.encode("utf-8")
        # True SentencePiece: byte-fallback pieces <0xNN>, metaspace = " ".
        if len(token) == 6 and token.startswith("<0x") and token.endswith(">"):
            try:
                return bytes([int(token[3:5], 16)])
            except ValueError:
                pass
        return token.replace("▁", " ").encode("utf-8")

    def token_bytes(self) -> List[bytes]:
        out = [b""] * self.vocab_size
        for token, tid in self.tk.get_vocab().items():
            if tid < self.vocab_size:
                out[tid] = self._token_to_bytes(token, tid)
        return out


def is_byte_stable(tokenizer: Tokenizer, probe: str = "") -> bool:
    """True when ``encode`` maps every character of a template to
    exactly its UTF-8 bytes — the property the mega-round's
    template-token assembly needs: slot token positions equal byte
    offsets, and substituting one fixed-width slot's text can never
    re-segment neighbouring tokens.  Checked empirically on the probe
    (plus a digit/punctuation alphabet) rather than by isinstance, so
    any future byte-faithful tokenizer qualifies and any BPE merge
    disqualifies itself.  BPE vocabularies fail here and the mega-round
    falls back to the lockstep path (DESIGN.md fallback matrix)."""
    text = probe + "0123456789 .:;-_{}\"'\nagent value Round"
    toks = tokenizer.encode(text)
    if list(toks) != list(text.encode("utf-8")):
        return False
    # Concat stability: per-fragment encodes must concatenate to the
    # whole — a merge across a fragment boundary breaks slot splicing.
    mid = len(text) // 2
    return (
        tokenizer.encode(text[:mid]) + tokenizer.encode(text[mid:])
        == list(toks)
    )


def number_token_table(
    tokenizer: Tokenizer, lo: int, hi: int, width: Optional[int] = None,
):
    """Pre-tokenized fixed-width decimal slot table for template
    assembly: row k (k in [0, hi-lo]) holds the tokens of ``lo+k``
    zero-padded to ``width`` chars; the FIRST row (index 0 of the
    returned table) is the all-dashes "absent" slot (``'-' * width``),
    so a device-side gather with index ``where(v >= 0, v - lo + 1, 0)``
    assembles present and absent slots from one table.  Returns
    ``(table [hi-lo+2, width] int32, width)``.  Requires a byte-stable
    tokenizer (:func:`is_byte_stable`) — widths are then exact."""
    import numpy as np

    width = width or len(str(hi))
    rows = ["-" * width] + [
        str(v).zfill(width) for v in range(lo, hi + 1)
    ]
    table = np.zeros((len(rows), width), dtype=np.int32)
    for i, text in enumerate(rows):
        toks = tokenizer.encode(text)
        if len(toks) != width:
            raise ValueError(
                f"slot text {text!r} tokenized to {len(toks)} != width "
                f"{width} tokens — tokenizer is not byte-stable"
            )
        table[i] = toks
    return table, width


def tokenizer_for_model(model_name: str, model_path: Optional[str] = None) -> Tokenizer:
    if model_name.startswith("bcg-tpu/"):
        from bcg_tpu_torch.models.configs import spec_for_model

        spec = spec_for_model(model_name)
        return ByteTokenizer(vocab_size=spec.vocab_size if spec else 512)
    if model_path is None:
        # Resolve to the local checkpoint dir first: AutoTokenizer given a
        # bare model NAME would try the network, which this environment
        # does not have (same zero-egress rule as the weight loader).
        from bcg_tpu_torch.models.loader import find_checkpoint_dir

        model_path = find_checkpoint_dir(model_name) or model_name
    return HFTokenizer(model_path)
