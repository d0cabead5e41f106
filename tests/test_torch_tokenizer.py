"""The port's ``tokenizer.json`` reader (``bcg_tpu_torch.engine.tokenizer.
HFTokenizer`` over ``engine/tokenizer_json.py``) against the JAX
package's ``HFTokenizer``, which wraps ``transformers.AutoTokenizer``.

Tokenizers under test, each saved as a checkpoint's three files:

* the three ``bcg-hf/*`` fixture families (``chatml``, ``llama3``,
  ``sentencepiece``), trained by the JAX package's ``hf_fixture``;
* two trained here with ``tokenizers`` on the real families' pipelines:
  Qwen2's ``Split`` pattern behind an NFC normalizer (class
  ``Qwen2Tokenizer``, its ``added_tokens_decoder`` in the config), and
  Llama-3's pattern with ``ignore_merges`` and
  ``clean_up_tokenization_spaces``;
* two SentencePiece-converted shapes made by editing a trained file:
  Llama-2's (``Prepend``/``Replace`` normalizer, ``byte_fallback``,
  ``fuse_unk``, a ``Replace``/``ByteFallback``/``Fuse``/``Strip``
  decoder) and Mistral's (``Metaspace`` with ``prepend_scheme: first``
  and no split);
* one with added tokens carrying ``single_word``, ``lstrip``, ``rstrip``
  and ``normalized`` flags.

Each is held token for token on a fixed corpus and a bounded hypothesis
corpus over the assigned planes (CJK, emoji, digits, contractions,
whitespace runs, newlines), with the same ``decode``, ``token_bytes``,
eos/pad/special ids, byte-level detection, ``is_byte_stable`` and
``number_token_table``.
"""

import json
import os
import subprocess
import sys

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from bcg_tpu.engine import tokenizer as j_tokenizer
from bcg_tpu.models import hf_fixture as j_fixture
from bcg_tpu_torch.engine import tokenizer as t_tokenizer
from bcg_tpu_torch.engine import tokenizer_json
import _torch_jax_obs_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QWEN2_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}|"
                 r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")

MULTILINGUAL = [
    "東京は日本の首都です。今日はいい天気ですね！",
    "中文分词测试：共识游戏中的拜占庭代理。",
    "한국어 텍스트와 숫자 12345 그리고 이모지 😀👍🏽🎉",
    "Ünïcödé façade — naïve café, déjà vu; ½ ² ³ ٣٤٥ ०१२",
    "I'm sure they'll say we've done it; YOU'RE right, it's DONE.",
    "tabs\tand   spaces\n\n\nnew  lines \r\n windows\u2028sep\xa0nbsp\u3000ideo",
    "Emoji families 👨‍👩‍👧‍👦 flags 🇯🇵🇺🇸 keycaps 1️⃣ and ZWJ.",
    "numbers 1234567890 3.14159 -42 +7e10 0x1F 1,000,000",
]

CORPUS = [
    "",
    " ",
    "Hello world",
    'You are agent_3 in a multi-agent consensus game. {"value": 17, "public_reasoning": "agents converge"}',
    '{"decision": "continue"}',
    "<|im_start|>system\nYou are helpful.<|im_end|>\n<|im_start|>assistant\n",
    "<|begin_of_text|><|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>",
    "<s>[INST] Propose a value. [/INST] 25 </s>",
    "▁probe▁ then a▁probe▁b and ▁▁double",
    "  leading and trailing  ",
    "\n\n\n",
    "x\x1cy\x1f z",
] + MULTILINGUAL


def _training_corpus():
    yield from j_fixture._training_corpus()
    for _ in range(8):
        yield from MULTILINGUAL


def _write_config(d, cfg, smap):
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    with open(os.path.join(d, "special_tokens_map.json"), "w") as f:
        json.dump(smap, f)


def _train_real_pattern(d, pattern, *, nfc, ignore_merges, specials, cfg, added=()):
    from tokenizers import AddedToken, Regex, Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, trainers

    os.makedirs(d, exist_ok=True)
    tok = Tokenizer(models.BPE(unk_token=None, ignore_merges=ignore_merges))
    if nfc:
        tok.normalizer = normalizers.NFC()
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(pattern), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=1400, special_tokens=[],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False)
    tok.train_from_iterator(_training_corpus(), trainer)
    tok.add_special_tokens([AddedToken(s, special=True, normalized=False) for s in specials])
    tok.add_tokens([AddedToken(s, special=False, normalized=False) for s in added])
    tok.save(os.path.join(d, "tokenizer.json"))
    _write_config(d, cfg, {k: v for k, v in cfg.items() if k.endswith("_token") and v})


def _edit(src_dir, d, edit, cfg):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(src_dir, "tokenizer.json")) as f:
        spec = json.load(f)
    edit(spec)
    with open(os.path.join(d, "tokenizer.json"), "w") as f:
        json.dump(spec, f, ensure_ascii=False)
    _write_config(d, cfg, {k: v for k, v in cfg.items() if k.endswith("_token") and v})


def _sentencepiece_bytes(spec, *, normalizer, pre, decoder):
    """A trained Metaspace BPE turned into a SentencePiece-converted
    file: the 256 byte pieces appended to the vocab, byte fallback on."""
    vocab = spec["model"]["vocab"]
    for b in range(256):
        vocab.setdefault(f"<0x{b:02X}>", len(vocab) + len(spec["added_tokens"]))
    spec["model"].update(byte_fallback=True, fuse_unk=True)
    spec["normalizer"] = normalizer
    spec["pre_tokenizer"] = pre
    spec["decoder"] = decoder


SP_DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
SP_CFG = {"tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
          "unk_token": "<unk>", "model_max_length": 8192}


def _llama2(spec):
    _sentencepiece_bytes(spec, normalizer={"type": "Sequence", "normalizers": [
        {"type": "Prepend", "prepend": "▁"},
        {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]},
        pre=None, decoder=SP_DECODER)


def _mistral(spec):
    _sentencepiece_bytes(spec, normalizer=None, pre={
        "type": "Metaspace", "replacement": "▁", "prepend_scheme": "first", "split": False},
        decoder=SP_DECODER)


def _flags(spec):
    """Added tokens with every matching flag, normalized and not."""
    n = len(spec["model"]["vocab"]) + len(spec["added_tokens"])
    rows = [
        ("<|sw|>", dict(single_word=True)), ("agentword", dict(single_word=True, normalized=True)),
        ("<|ls|>", dict(lstrip=True)), ("<|rs|>", dict(rstrip=True)),
        ("<|both|>", dict(lstrip=True, rstrip=True, special=True)),
        ("value", dict(normalized=True)),
    ]
    for k, (content, flags) in enumerate(rows):
        row = {"id": n + k, "content": content, "single_word": False, "lstrip": False,
               "rstrip": False, "normalized": False, "special": False}
        row.update(flags)
        spec["added_tokens"].append(row)


FAMILIES = ["chatml", "llama3", "sentencepiece", "qwen2-nfc", "llama3-ignore-merges",
            "llama2-bytes", "mistral-first", "added-flags"]


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("tokenizers")
    dirs = {}
    for fam in ("chatml", "llama3", "sentencepiece"):
        dirs[fam] = str(root / fam)
        j_fixture.build_tokenizer_files(dirs[fam], 448, fam)
    qwen_specials = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
    dirs["qwen2-nfc"] = str(root / "qwen2-nfc")
    _train_real_pattern(
        dirs["qwen2-nfc"], QWEN2_PATTERN, nfc=True, ignore_merges=False,
        specials=qwen_specials, added=["<think>", "</think>"],
        cfg={"tokenizer_class": "Qwen2Tokenizer", "eos_token": "<|im_end|>",
             "pad_token": "<|endoftext|>", "bos_token": None, "unk_token": None,
             "clean_up_tokenization_spaces": False, "model_max_length": 8192})
    # The config's added_tokens_decoder, as a Qwen checkpoint ships it.
    with open(os.path.join(dirs["qwen2-nfc"], "tokenizer.json")) as f:
        added = json.load(f)["added_tokens"]
    cfg_path = os.path.join(dirs["qwen2-nfc"], "tokenizer_config.json")
    with open(cfg_path) as f:
        cfg = json.load(f)
    cfg["added_tokens_decoder"] = {str(r["id"]): {k: v for k, v in r.items() if k != "id"}
                                   for r in added}
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    dirs["llama3-ignore-merges"] = str(root / "llama3-im")
    _train_real_pattern(
        dirs["llama3-ignore-merges"], LLAMA3_PATTERN, nfc=False, ignore_merges=True,
        specials=j_fixture.LLAMA3_SPECIALS,
        cfg={"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|eot_id|>",
             "bos_token": "<|begin_of_text|>", "clean_up_tokenization_spaces": True,
             "model_max_length": 8192})
    sp_cfg = dict(SP_CFG)
    dirs["llama2-bytes"] = str(root / "llama2")
    _edit(dirs["sentencepiece"], dirs["llama2-bytes"], _llama2, sp_cfg)
    dirs["mistral-first"] = str(root / "mistral")
    _edit(dirs["sentencepiece"], dirs["mistral-first"], _mistral, sp_cfg)
    dirs["added-flags"] = str(root / "flags")
    _edit(dirs["chatml"], dirs["added-flags"], _flags,
          {"tokenizer_class": "PreTrainedTokenizerFast", "eos_token": "<|im_end|>",
           "pad_token": "<|endoftext|>"})
    return dirs


@pytest.fixture(scope="module")
def pairs(tok_dirs):
    return {fam: (t_tokenizer.HFTokenizer(d), j_tokenizer.HFTokenizer(d))
            for fam, d in tok_dirs.items()}


def _same_text(mine, ref, text):
    ids = ref.encode(text)
    assert mine.encode(text) == ids, text
    assert mine.decode(ids) == ref.decode(ids), text


@pytest.mark.parametrize("fam", FAMILIES)
def test_reader_encodes_and_decodes_the_corpus_as_transformers(pairs, fam):
    mine, ref = pairs[fam]
    for text in CORPUS:
        _same_text(mine, ref, text)
    # Decoding arbitrary id runs: specials skipped, byte pieces merged,
    # invalid UTF-8 replaced as the reference does.
    n = ref.vocab_size
    for start in range(0, n, 37):
        ids = list(range(start, min(n, start + 23)))
        assert mine.decode(ids) == ref.decode(ids), ids


@pytest.mark.parametrize("fam", FAMILIES)
def test_reader_tables_equal_transformers(pairs, fam):
    mine, ref = pairs[fam]
    assert mine.vocab_size == ref.vocab_size
    assert (mine.eos_id, mine.pad_id) == (ref.eos_id, ref.pad_id)
    assert mine._special_ids == ref._special_ids
    assert mine._added_ids == ref._added_ids
    assert mine._byte_level == ref._byte_level
    assert mine.token_bytes() == ref.token_bytes()
    assert t_tokenizer.is_byte_stable(mine) == j_tokenizer.is_byte_stable(ref)
    for lo, hi in ((0, 50), (0, 9), (1, 3)):
        try:
            want = j_tokenizer.number_token_table(ref, lo, hi)
        except ValueError as exc:
            with pytest.raises(ValueError):
                t_tokenizer.number_token_table(mine, lo, hi)
            assert "byte-stable" in str(exc)
        else:
            got = t_tokenizer.number_token_table(mine, lo, hi)
            assert got[1] == want[1] and (got[0] == want[0]).all()


_PIECES = st.sampled_from([
    "'s", "'T", "'re", "'VE", "'m", "'ll", "'D", "ſ", " ", "  ", "\t", "\n", "\r\n", "\n\n ",
    "\xa0", "\u3000", "\u2003", "\u2028", "\x85", "\x1c", "😀", "👍🏽", "👨‍👩‍👧", "🇯🇵", "中文", "日本語", "한국어",
    "123", "4567", "٣", "²", "½", "é", "ﬁ", "Å", "<|im_end|>", "<|im_start|>", "<s>",
    "</s>", "<|eot_id|>", "▁", "▁probe▁", "<|sw|>", "agentword", "<|ls|>", "<|rs|>",
    "<|both|>", "value", "_", "<think>", "{\"", "\":", "<0x41>",
])
_TEXT = st.lists(
    st.one_of(_PIECES,
              st.text(st.characters(exclude_categories=("Cs", "Cn", "Co")), max_size=6)),
    max_size=12).map("".join)


@pytest.mark.parametrize("fam", FAMILIES)
@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture,
                                 HealthCheck.too_slow])
@given(text=_TEXT)
def test_reader_matches_transformers_on_generated_text(pairs, fam, text):
    mine, ref = pairs[fam]
    _same_text(mine, ref, text)


def test_regex_classes_follow_unicode_not_python_whitespace():
    rx = tokenizer_json.compile_regex(r"\s+|\S+")
    # U+001C..U+001F are str.isspace() in Python, not White_Space.
    assert [m.group() for m in rx.finditer("a\x1cb c")] == ["a\x1cb", " ", "c"]
    letters = tokenizer_json.compile_regex(r"\p{L}+")
    assert letters.fullmatch("日本語Ωé") and not letters.match("١")
    digits = tokenizer_json.compile_regex(r"\p{N}+")
    assert digits.fullmatch("١٢٣²½")


@pytest.mark.parametrize("where,component", [
    ("normalizer", {"type": "Lowercase"}),
    ("pre_tokenizer", {"type": "Whitespace"}),
    ("decoder", {"type": "WordPiece", "prefix": "##", "cleanup": True}),
    ("model", {"type": "Unigram", "vocab": [["a", 0.0]]}),
])
def test_an_unimplemented_component_raises_naming_it(tok_dirs, tmp_path, where, component):
    with open(os.path.join(tok_dirs["chatml"], "tokenizer.json")) as f:
        spec = json.load(f)
    spec[where] = component
    with open(tmp_path / "tokenizer.json", "w") as f:
        json.dump(spec, f)
    with pytest.raises(NotImplementedError, match=component["type"]):
        t_tokenizer.HFTokenizer(str(tmp_path))


def test_reader_needs_neither_transformers_nor_tokenizers(tok_dirs):
    code = (
        "import sys\n"
        "from bcg_tpu_torch.engine.tokenizer import HFTokenizer\n"
        f"t = HFTokenizer({tok_dirs['qwen2-nfc']!r})\n"
        "assert t.decode(t.encode('agent_3 value 17')) == 'agent_3 value 17'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('transformers', 'tokenizers', 'jax', 'bcg_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
