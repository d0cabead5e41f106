"""Tokenizers.

The engine needs three things from a tokenizer: encode/decode, a byte
representation of every vocabulary entry (to build token DFAs), and the
special ids.  Two implementations:

* :class:`ByteTokenizer` — hermetic byte-level tokenizer (token i =
  byte i, plus specials), used by the tiny-test and bench models.
* :class:`HFTokenizer` — a local HuggingFace tokenizer for real
  checkpoints (Qwen3 / Llama-3 / Mistral), read from its
  ``tokenizer.json`` by the port's own reader (no ``transformers``),
  recovering token byte strings from the GPT-2 byte-unicode table or
  SentencePiece metaspace.
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
    from bcg_tpu_torch.engine.tokenizer_json import bytes_to_unicode

    return {c: b for b, c in bytes_to_unicode().items()}


# The special-token attributes ``transformers`` reads from
# tokenizer_config.json (then special_tokens_map.json), in its order.
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token")
# ``tokenizer_class`` -> the class's own special-token defaults (what
# ``AutoTokenizer`` applies to a key the files leave out entirely).  A
# class outside this table raises: its fast tokenizer may rewrite the
# pipeline at load.
_CLASS_DEFAULTS = {
    None: {},
    "PreTrainedTokenizerFast": {},
    "Qwen2Tokenizer": {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                       "pad_token": "<|endoftext|>"},
    "Qwen2TokenizerFast": {"unk_token": "<|endoftext|>", "eos_token": "<|endoftext|>",
                           "pad_token": "<|endoftext|>"},
    "LlamaTokenizer": {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"},
    "LlamaTokenizerFast": {"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"},
}


def _content(tok):
    """A special-token value of the config files: a string, or an
    ``AddedToken`` serialized as a dict with ``content``."""
    if isinstance(tok, dict):
        return tok.get("content")
    return tok


def _read_json(path: str) -> dict:
    import json

    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _clean_up_tokenization(text: str) -> str:
    """``transformers``' ``clean_up_tokenization``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


class HFTokenizer(Tokenizer):
    """A local HuggingFace tokenizer, read from its files by the port's
    own reader (``engine/tokenizer_json.py``) — ``tokenizer.json``,
    ``tokenizer_config.json`` and ``special_tokens_map.json`` — with no
    ``transformers`` or ``tokenizers`` on any machine.  It loads them as
    ``transformers.AutoTokenizer`` does: config special tokens resolved
    with ``special_tokens_map.json`` and the class defaults filling the
    gaps, registered as special added tokens where ``tokenizer.json``
    lacks them, ``added_tokens_decoder`` flags applied over the file's,
    a top-level ``ByteLevel``'s ``add_prefix_space`` set from the config,
    and ``clean_up_tokenization_spaces`` on decode.  Token byte strings
    come from the GPT-2 byte-unicode table or SentencePiece metaspace."""

    def __init__(self, path: str, vocab_id: Optional[int] = None):
        from bcg_tpu_torch.engine.tokenizer_json import AddedToken, TokenizerJson, add_tokens

        spec = _read_json(os.path.join(path, "tokenizer.json"))
        if not spec:
            raise FileNotFoundError(
                f"no tokenizer.json under {path!r} (the port reads only "
                "tokenizer.json checkpoints, not slow-tokenizer files)")
        cfg = _read_json(os.path.join(path, "tokenizer_config.json"))
        smap = _read_json(os.path.join(path, "special_tokens_map.json"))
        cls = cfg.get("tokenizer_class")
        if cls not in _CLASS_DEFAULTS:
            raise NotImplementedError(f"tokenizer_class {cls!r}")
        if cls and cls.startswith("Llama") and cfg.get("add_prefix_space") is not None:
            raise NotImplementedError(
                f"{cls} with add_prefix_space (rebuilt from the slow tokenizer)")
        defaults = _CLASS_DEFAULTS[cls]

        missing = object()
        special: dict = {}
        for key in _SPECIAL_KEYS + ("additional_special_tokens",):
            val = cfg.get(key, missing)
            if (val is missing or not val) and key in smap:
                val = smap[key]
            if val is missing:
                val = defaults.get(key)
            special[key] = val
        additional = special.pop("additional_special_tokens") or []
        special_tokens = [_content(special[k]) for k in _SPECIAL_KEYS]
        self._special_tokens = [t for t in special_tokens + [_content(t) for t in additional]
                                if t is not None]

        # The file's added tokens with the ids tokenizers gives them, the
        # config's added_tokens_decoder flags over them, then the config's
        # special tokens the file lacks (transformers' load order).
        model = spec.get("model") or {}
        if model.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model: {model.get('type')}")
        vocab = model.get("vocab", {})
        added: dict = {}
        add_tokens(added, [AddedToken.from_json(r) for r in spec.get("added_tokens", [])], vocab)
        extra = []
        for sid, row in (cfg.get("added_tokens_decoder") or {}).items():
            tok = AddedToken.from_json(row, id=int(sid))
            have = added.get(tok.id)
            if have is None or have.content != tok.content:
                raise NotImplementedError(
                    f"tokenizer_config added_tokens_decoder entry {sid}: {tok.content!r} "
                    "is not the tokenizer.json added token of that id")
            if have.flags() != tok.flags():
                tok.special = tok.special or tok.content in self._special_tokens
                if have.special and not tok.special:
                    raise NotImplementedError(
                        f"tokenizer_config unmarks special added token {tok.content!r}")
                extra.append(tok)
        present = {t.content for t in added.values()}
        extra += [AddedToken(-1, c, normalized=False, special=True)
                  for c in dict.fromkeys(self._special_tokens) if c not in present]

        pre = spec.get("pre_tokenizer")
        prefix = cfg.get("add_prefix_space", False)
        if (isinstance(pre, dict) and pre.get("type") == "ByteLevel"
                and "add_prefix_space" in pre and prefix is not None
                and pre["add_prefix_space"] != prefix):
            pre = dict(pre, add_prefix_space=bool(prefix))
        self._tj = TokenizerJson(spec, extra_added=extra, pre_tokenizer_override=pre)
        self._clean_up = bool(cfg.get("clean_up_tokenization_spaces", False))
        self._spec = dict(spec, pre_tokenizer=pre)

        self._vocab = self._tj.vocab()
        self.vocab_size = len(self._vocab)
        eos, pad = _content(special["eos_token"]), _content(special["pad_token"])
        self.eos_id = self._vocab.get(eos) if eos is not None else None
        self.pad_id = self._vocab.get(pad) if pad is not None else self.eos_id
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
        self._added_ids = set(self._tj.added)
        # Control tokens are marked special in tokenizer.json's
        # added_tokens — ALL of them must be forbidden in guided decoding
        # (b'' in the DFA), beside the config-declared special tokens.
        self._special_ids = {
            self._vocab[t] for t in self._special_tokens if t in self._vocab
        } | {tid for tid, tok in self._tj.added.items() if tok.special}

    def _detect_byte_level(self) -> bool:
        """True for GPT-2-style byte-level-BPE vocabs (Qwen, Llama-3,
        GPT-2), False for true SentencePiece vocabs (Llama-2, Mistral
        pre-tekken).

        The vocab family decides how token strings map to bytes; checking
        string CONTENT per token mis-decodes any byte-BPE vocab entry that
        happens to contain a literal ``▁`` — e.g. an added token —
        corrupting the token DFA for every schema.  Read the declared
        pre-tokenizer/decoder instead; fall back to a whole-vocab scan for
        the byte-level space marker ``Ġ`` (U+0120), which every byte-BPE
        vocab contains and no SentencePiece vocab does.
        """
        spec = self._spec

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
        return any("Ġ" in t for t in self._vocab)

    def encode(self, text: str) -> List[int]:
        return self._tj.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tj.decode(list(ids), skip_special_tokens=True)
        return _clean_up_tokenization(text) if self._clean_up else text

    def _token_to_bytes(self, token: str, tid: int) -> bytes:
        if tid in self._special_ids:
            return b""
        if tid in self._added_ids:
            # Non-special added token: raw string, whatever the family.
            return token.encode("utf-8")
        if self._byte_level:
            # GPT-2 byte-unicode table (byte-level is decided per VOCAB, so
            # a literal metaspace inside a byte-BPE token can never divert
            # it to the SentencePiece branch).
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
        for token, tid in self._vocab.items():
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
