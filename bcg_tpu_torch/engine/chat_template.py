"""Per-model-family chat templating.

The reference hand-rolls these formats in ``vllm_agent.py:199-292``; the
template strings themselves are the models' public chat formats (ChatML,
Llama-3 headers, Mistral ``[INST]``), so they must match byte-for-byte —
a wrong template silently wrecks game behaviour (SURVEY.md §7 hard part
3).  Family is auto-detected from the model name, mirroring the
reference's dispatch order:

1. Qwen3 Instruct-2507  -> ChatML (no thinking mode)
2. Qwen3                -> ChatML, ``/no_think`` soft switch appended to
                           the user turn when thinking is disabled
3. other Qwen           -> ChatML
4. Llama-3              -> header-id format
5. other Llama/Mistral  -> ``[INST]`` with ``<<SYS>>``
6. fallback             -> ChatML
"""

from __future__ import annotations

from typing import Tuple


def _chatml(system_prompt: str, user_prompt: str) -> Tuple[str, str]:
    return (
        f"<|im_start|>system\n{system_prompt}<|im_end|>\n",
        f"<|im_start|>user\n{user_prompt}<|im_end|>\n"
        f"<|im_start|>assistant\n",
    )


def format_chat_parts(
    model_name: str,
    system_prompt: str,
    user_prompt: str,
    disable_qwen3_thinking: bool = True,
) -> Tuple[str, str]:
    """(prefix, suffix) halves of the chat prompt; full = prefix + suffix.

    The prefix covers everything through the (static, per-role) system
    segment and the suffix everything from the user turn on, so the engine
    can prefill the prefix once per run and reuse its KV cache across every
    round's decision and vote calls (prefix caching — the TPU equivalent
    of the reference's cached-system-prompt prefix-reuse design,
    bcg_agents.py:24-27,174-177).
    """
    m = model_name.lower()

    if "qwen3" in m or "qwen-3" in m:
        if "instruct-2507" in m or "instruct_2507" in m:
            return _chatml(system_prompt, user_prompt)
        if disable_qwen3_thinking:
            return _chatml(system_prompt, f"{user_prompt} /no_think")
        return _chatml(system_prompt, user_prompt)

    if "qwen" in m:
        return _chatml(system_prompt, user_prompt)

    if "llama-3" in m or "llama3" in m:
        return (
            "<|begin_of_text|><|start_header_id|>system<|end_header_id|>\n\n"
            f"{system_prompt}<|eot_id|>",
            "<|start_header_id|>user<|end_header_id|>\n\n"
            f"{user_prompt}<|eot_id|>"
            "<|start_header_id|>assistant<|end_header_id|>\n\n",
        )

    if "llama" in m or "mistral" in m:
        return (
            f"<s>[INST] <<SYS>>\n{system_prompt}\n<</SYS>>\n\n",
            f"{user_prompt} [/INST]",
        )

    return _chatml(system_prompt, user_prompt)


def format_chat_parts3(
    model_name: str,
    system_prompt: str,
    core: str,
    tail: str,
    disable_qwen3_thinking: bool = True,
) -> Tuple[str, str, str]:
    """(prefix, core_text, tail_text) thirds of the chat prompt, where
    ``core + tail`` is the user turn.  Invariant: the concatenation of
    the three equals ``format_chat_prompt(system, core + tail)`` exactly.

    Used by vote-phase shared-core prefix caching: ``core`` (the round's
    proposals + history, identical across agents of a role) is prefilled
    once per round against the cached role-system prefix; only the tiny
    per-agent ``tail`` prefills per row.  The core_text keeps the user
    opener; the tail_text keeps the closer (and the Qwen3 ``/no_think``
    switch, which belongs at the END of the user turn).
    """
    prefix, suffix = format_chat_parts(
        model_name, system_prompt, core + tail, disable_qwen3_thinking
    )
    if not core:
        return prefix, "", suffix
    idx = suffix.find(core)
    if idx < 0:  # defensive: template transformed the user text
        return prefix, "", suffix
    cut = idx + len(core)
    return prefix, suffix[:cut], suffix[cut:]


def format_chat_prompt(
    model_name: str,
    system_prompt: str,
    user_prompt: str,
    disable_qwen3_thinking: bool = True,
) -> str:
    prefix, suffix = format_chat_parts(
        model_name, system_prompt, user_prompt, disable_qwen3_thinking
    )
    return prefix + suffix


def prefix_split_safe(model_name: str) -> bool:
    """True when this family's prefix/suffix split (format_chat_parts)
    lands on a special-token boundary, so encode(prefix) + encode(suffix)
    == encode(prefix + suffix) and the prefix KV can be cached.

    ChatML prefixes end at ``<|im_end|>\\n`` followed by the special
    ``<|im_start|>``, and Llama-3 at ``<|eot_id|>`` — safe.  The
    Mistral/Llama-2 ``[INST]`` prefix ends in bare text where a BPE merge
    could straddle the split — not safe.  KEEP IN SYNC with the family
    dispatch above: a new family whose prefix ends in bare text must
    return False here or prefix caching will silently corrupt prompts at
    the seam.
    """
    m = model_name.lower()
    if "llama-3" in m or "llama3" in m:
        return True
    if "llama" in m or "mistral" in m:
        return False
    return True  # ChatML families and the ChatML fallback
