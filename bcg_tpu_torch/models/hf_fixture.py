"""Hermetic HuggingFace artifact construction — the port's copy of
``bcg_tpu/models/hf_fixture.py``.

The checkpoint is written with the port's numpy safetensors writer
(``models/safetensors_np.py``), not ``safetensors``/``ml_dtypes``.  The
tokenizer is trained with ``tokenizers``, which a GPU host may lack, so
the three trained sets of the tiny fixtures' vocabulary
ship with the package (``models/fixture_tokenizers/<family>/``, the same
bytes training writes; ``tests/test_torch_hf_fixture.py`` holds them to
it) and :func:`build_tokenizer_files` copies a shipped set when one
matches, else trains.

A machine with zero network egress cannot prove the real-model pipeline —
``find_checkpoint_dir`` → ``load_checkpoint_params`` →
``HFTokenizer.token_bytes`` → token DFA → chat template (everything the
reference gets from the HF hub + vLLM boot, ``vllm_agent.py:100-157``) —
cannot be proven against a downloaded Qwen3 checkpoint.  It CAN be
proven against a *genuine* artifact set constructed on disk:

* a real byte-level-BPE ``tokenizer.json`` built with the ``tokenizers``
  library — GPT-2 byte-unicode alphabet, trained merges, ChatML special
  tokens — loaded through the port's ``tokenizer.json`` reader exactly
  like a hub checkpoint;
* a real-layout safetensors checkpoint: HF parameter names
  (``model.layers.{i}.self_attn.q_proj.weight`` …), ``[out, in]``
  projection layout, bf16 storage, multi-shard with an index file;
* an HF-style ``config.json`` carrying the architecture fields.

Nothing in the loading path knows these artifacts are synthetic — the
only difference from a hub snapshot is that the weights are random.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Iterable, List, Optional

import numpy as np

from bcg_tpu_torch.models.configs import ModelSpec, spec_for_model

# Trained tokenizer sets shipped with the package, one directory per
# family (a host without ``tokenizers`` cannot train them).
SHIPPED_TOKENIZERS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "fixture_tokenizers")
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "special_tokens_map.json")

# ChatML specials, matching the chat_template fallback family used for
# bcg-hf/* model names (engine/chat_template.py).
CHATML_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]
# Llama-3 specials (the header-id template family, reference
# vllm_agent.py:236-252): fixture names containing "llama3" build a
# byte-BPE vocab with these, so the Llama-3 template meets a
# Llama-3-shaped vocabulary (VERDICT round-2 missing #3).
LLAMA3_SPECIALS = [
    "<|begin_of_text|>", "<|end_of_text|>",
    "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>",
]
# True-SentencePiece specials (Llama-2/Mistral [INST] family,
# vllm_agent.py:254-269): fixture names containing "mistral" build a
# Metaspace-pretokenized vocab — the engine must DETECT it as
# non-byte-level and route token bytes through the metaspace branch.
SP_SPECIALS = ["<unk>", "<s>", "</s>"]


def fixture_family(model_name: str) -> str:
    """Tokenizer/template family for a ``bcg-hf/*`` fixture name —
    intentionally the same name-substring dispatch the chat template
    uses, so fixture artifacts and template selection can't disagree."""
    m = model_name.lower()
    if "llama3" in m or "llama-3" in m:
        return "llama3"
    if "mistral" in m or "llama" in m:
        return "sentencepiece"
    return "chatml"
# A literal-metaspace token added as a NON-special vocab entry: the
# round-1 ``_token_to_bytes`` heuristic (metaspace checked before the
# byte table) silently mis-decoded exactly this shape of entry in a
# byte-level-BPE vocab — kept in the fixture as a permanent regression
# input for the tokenizer tests.
METASPACE_PROBE_TOKEN = "▁probe▁"

# Shard size cap: small enough that the bench-1b fixture splits into
# several shards, exercising the loader's name->file indexing.
_MAX_SHARD_BYTES = 1 << 30


def _training_corpus() -> Iterable[str]:
    """Synthetic corpus shaped like the game's actual token stream:
    prompt prose, agent/value vocabulary, and JSON decision payloads."""
    base = [
        "You are agent_{i} in a multi-agent consensus game. Your current "
        "value is {v}. Propose a value between 0 and 50.",
        '{{"internal_strategy": "converge toward the median of recent '
        'proposals", "value": {v}, "public_reasoning": "Values are '
        'clustering near {v}, so I am moving toward the group."}}',
        '{{"decision": "continue"}} {{"decision": "stop"}} '
        '{{"decision": "abstain"}}',
        "Round {i}: agent_{i} value: {v} | Reasoning: moving toward the "
        "median to reach consensus quickly.",
        "The quick brown fox jumps over the lazy dog. 0123456789 "
        "agreement rate, Byzantine agents may exist, vote to terminate.",
        "history shows values 12, 17, 23, 25, 25, 25 converging; "
        "suspicious outlier at 49 ignored.",
    ]
    for i in range(64):
        for t in base:
            yield t.format(i=i % 10, v=(i * 7) % 51)


# The tokenizer vocabulary of the tiny bcg-hf/* fixtures (512 - 64): the
# size of the shipped sets.
SHIPPED_VOCAB = 448


def shipped_tokenizer_dir(family: str, vocab_size: int) -> Optional[str]:
    """The shipped set of ``family`` — trained at ``SHIPPED_VOCAB`` — when
    ``vocab_size`` asks for that size, else None."""
    d = os.path.join(SHIPPED_TOKENIZERS, family)
    if vocab_size == SHIPPED_VOCAB and os.path.exists(os.path.join(d, "tokenizer.json")):
        return d
    return None


def build_tokenizer_files(
    out_dir: str, vocab_size: int, family: str = "chatml"
) -> None:
    """Save a tokenizer artifact set into ``out_dir``: the shipped set of
    ``family`` when it has ``vocab_size`` entries, else one trained with
    ``tokenizers`` (``ImportError`` naming it when it is absent).

    ``vocab_size`` counts the FULL tokenizer vocabulary (trained entries
    + specials + the metaspace probe token).  ``family``:

    * ``chatml`` — byte-level BPE, ChatML specials (Qwen-style);
    * ``llama3`` — byte-level BPE, Llama-3 header-id specials, eos
      ``<|eot_id|>``;
    * ``sentencepiece`` — Metaspace-pretokenized BPE (true-SentencePiece
      shape: ``▁``-pieces, NOT byte-level), ``<s>``/``</s>`` specials.
    """
    os.makedirs(out_dir, exist_ok=True)
    shipped = shipped_tokenizer_dir(family, vocab_size)
    if shipped is not None:
        for name in TOKENIZER_FILES:
            shutil.copyfile(os.path.join(shipped, name), os.path.join(out_dir, name))
        return
    try:
        from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    except ImportError as exc:
        raise ImportError(
            f"training a {family!r} fixture tokenizer of {vocab_size} entries needs the "
            "`tokenizers` package; only the shipped sets "
            f"(models/fixture_tokenizers/, {SHIPPED_VOCAB} entries) build without it"
        ) from exc

    if family == "sentencepiece":
        tok = Tokenizer(models.BPE(unk_token="<unk>"))
        tok.pre_tokenizer = pre_tokenizers.Metaspace()
        tok.decoder = decoders.Metaspace()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size - len(SP_SPECIALS),
            special_tokens=SP_SPECIALS,
            show_progress=False,
        )
        tok.train_from_iterator(_training_corpus(), trainer)
        tok.save(os.path.join(out_dir, "tokenizer.json"))
        cfg = {
            "tokenizer_class": "PreTrainedTokenizerFast",
            "eos_token": "</s>", "bos_token": "<s>",
            "unk_token": "<unk>", "pad_token": "</s>",
            "model_max_length": 8192,
        }
        specials_map = {"eos_token": "</s>", "bos_token": "<s>",
                        "unk_token": "<unk>", "pad_token": "</s>"}
    else:
        specials = LLAMA3_SPECIALS if family == "llama3" else CHATML_SPECIALS
        n_added = len(specials) + 1
        tok = Tokenizer(models.BPE(unk_token=None))
        tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
        tok.decoder = decoders.ByteLevel()
        trainer = trainers.BpeTrainer(
            vocab_size=vocab_size - n_added,
            special_tokens=[],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False,
        )
        tok.train_from_iterator(_training_corpus(), trainer)
        tok.add_special_tokens(specials)
        tok.add_tokens([METASPACE_PROBE_TOKEN])
        tok.save(os.path.join(out_dir, "tokenizer.json"))
        if family == "llama3":
            cfg = {
                "tokenizer_class": "PreTrainedTokenizerFast",
                "eos_token": "<|eot_id|>",
                "pad_token": "<|end_of_text|>",
                "bos_token": "<|begin_of_text|>",
                "model_max_length": 8192,
            }
            specials_map = {"eos_token": "<|eot_id|>",
                            "pad_token": "<|end_of_text|>",
                            "bos_token": "<|begin_of_text|>"}
        else:
            cfg = {
                "tokenizer_class": "PreTrainedTokenizerFast",
                "eos_token": "<|im_end|>",
                "pad_token": "<|endoftext|>",
                "bos_token": None,
                "additional_special_tokens": ["<|im_start|>"],
                "model_max_length": 8192,
            }
            specials_map = {"eos_token": "<|im_end|>",
                            "pad_token": "<|endoftext|>"}
    with open(os.path.join(out_dir, "tokenizer_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)
    with open(os.path.join(out_dir, "special_tokens_map.json"), "w") as f:
        json.dump(specials_map, f)


def _hf_config(spec: ModelSpec) -> Dict:
    """HF ``config.json`` payload (architecture family from the name)."""
    family = fixture_family(spec.name)
    arch, mtype = {
        "llama3": (["LlamaForCausalLM"], "llama"),
        "sentencepiece": (["MistralForCausalLM"], "mistral"),
        "chatml": (["Qwen3ForCausalLM"], "qwen3"),
    }[family]
    return {
        "architectures": arch,
        "model_type": mtype,
        "vocab_size": spec.vocab_size,
        "hidden_size": spec.hidden_size,
        "num_hidden_layers": spec.num_layers,
        "num_attention_heads": spec.num_heads,
        "num_key_value_heads": spec.num_kv_heads,
        "head_dim": spec.head_dim,
        "intermediate_size": spec.intermediate_size,
        "rope_theta": spec.rope_theta,
        "rms_norm_eps": spec.rms_eps,
        "max_position_embeddings": spec.max_position,
        "tie_word_embeddings": spec.tie_embeddings,
        "torch_dtype": "bfloat16",
    }


def _tensor_specs(spec: ModelSpec) -> List:
    """(hf_name, shape) for every tensor, HF ``[out, in]`` layout —
    mirror of the loader's ``_LAYER_MAP``/``_TOP_MAP`` so generated
    checkpoints and the loader can never drift apart silently."""
    from bcg_tpu_torch.models.loader import _LAYER_MAP, _TOP_MAP, _TRANSPOSED

    shapes = {
        "embed": (spec.vocab_size, spec.hidden_size),
        "final_norm": (spec.hidden_size,),
        "lm_head": (spec.vocab_size, spec.hidden_size),
        "attn_norm": (spec.hidden_size,),
        "wq": (spec.q_size, spec.hidden_size),
        "wk": (spec.kv_size, spec.hidden_size),
        "wv": (spec.kv_size, spec.hidden_size),
        "bq": (spec.q_size,),
        "bk": (spec.kv_size,),
        "bv": (spec.kv_size,),
        "wo": (spec.hidden_size, spec.q_size),
        "q_norm": (spec.head_dim,),
        "k_norm": (spec.head_dim,),
        "mlp_norm": (spec.hidden_size,),
        "w_gate": (spec.intermediate_size, spec.hidden_size),
        "w_up": (spec.intermediate_size, spec.hidden_size),
        "w_down": (spec.hidden_size, spec.intermediate_size),
    }
    del _TRANSPOSED  # layout already expressed in `shapes`
    out = []
    for logical, hf_name in _TOP_MAP.items():
        if logical == "lm_head" and spec.tie_embeddings:
            continue
        out.append((hf_name, shapes[logical]))
    for i in range(spec.num_layers):
        for logical, template in _LAYER_MAP.items():
            if logical in ("q_norm", "k_norm") and not spec.qk_norm:
                continue
            if logical in ("bq", "bk", "bv") and not spec.attn_bias:
                continue
            out.append((template.format(i=i), shapes[logical]))
    return out


def build_checkpoint(
    model_name: str,
    out_dir: Optional[str] = None,
    seed: int = 0,
    force: bool = False,
) -> str:
    """Materialize the full HF artifact set for ``model_name`` (a
    ``bcg-hf/*`` spec) and return the checkpoint directory.

    Idempotent: an existing complete checkpoint is returned as-is unless
    ``force``.  Weights are N(0, 0.02) bf16 — random, but stored and
    laid out exactly like a hub snapshot.
    """
    import torch

    from bcg_tpu_torch.models.safetensors_np import save_file

    spec = spec_for_model(model_name)
    if spec is None:
        raise ValueError(f"no ModelSpec registered for {model_name!r}")
    if out_dir is None:
        out_dir = os.path.join("checkpoints", model_name.replace("/", "--"))
    done_marker = os.path.join(out_dir, ".complete")
    if os.path.exists(done_marker) and not force:
        return out_dir
    os.makedirs(out_dir, exist_ok=True)

    # Tokenizer vocab leaves headroom below the model vocab, like real
    # families (Qwen3: tokenizer 151669 < embedding 151936).
    build_tokenizer_files(
        out_dir, vocab_size=spec.vocab_size - 64,
        family=fixture_family(model_name),
    )
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(_hf_config(spec), f, indent=2)

    rng = np.random.default_rng(seed)
    specs = _tensor_specs(spec)
    shards: List[List] = [[]]
    shard_bytes = 0
    for hf_name, shape in specs:
        nbytes = int(np.prod(shape)) * 2
        if shard_bytes and shard_bytes + nbytes > _MAX_SHARD_BYTES:
            shards.append([])
            shard_bytes = 0
        shards[-1].append((hf_name, shape))
        shard_bytes += nbytes

    index = {"metadata": {"total_size": 0}, "weight_map": {}}
    n = len(shards)
    for si, shard in enumerate(shards, start=1):
        fname = (
            "model.safetensors"
            if n == 1
            else f"model-{si:05d}-of-{n:05d}.safetensors"
        )
        tensors = {}
        for hf_name, shape in shard:
            arr = rng.standard_normal(shape, dtype=np.float32) * 0.02
            if hf_name.endswith("norm.weight"):
                arr = np.ones(shape, dtype=np.float32)
            # float32 -> bfloat16 rounds to nearest even, as ml_dtypes does.
            tensors[hf_name] = torch.from_numpy(arr).to(torch.bfloat16)
            index["weight_map"][hf_name] = fname
            index["metadata"]["total_size"] += tensors[hf_name].numel() * 2
        save_file(tensors, os.path.join(out_dir, fname))
    if n > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)

    with open(done_marker, "w") as f:
        f.write("ok\n")
    return out_dir
