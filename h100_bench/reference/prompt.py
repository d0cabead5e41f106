"""The reference's own prompt formatting and tokenization, as the
configuration states them: the ChatML template, and a byte tokenizer
whose token ``i < 256`` is byte ``i``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

UserPrompt = Union[str, Tuple[str, str]]


def chatml(system: str, user: UserPrompt) -> str:
    """The ChatML conversation of one request, up to the assistant turn.
    A ``(core, tail)`` user prompt is the concatenation of its parts."""
    if isinstance(user, (tuple, list)):
        user = "".join(user)
    return (f"<|im_start|>system\n{system}<|im_end|>\n"
            f"<|im_start|>user\n{user}<|im_end|>\n"
            f"<|im_start|>assistant\n")


def prompt_tokens(system: str, user: UserPrompt, tokenizer: Dict) -> List[int]:
    if tokenizer.get("kind") != "bytes":
        raise NotImplementedError(f"tokenizer {tokenizer!r}")
    if tokenizer.get("template") != "chatml":
        raise NotImplementedError(f"template {tokenizer.get('template')!r}")
    return list(chatml(system, user).encode("utf-8"))


def served_tokens(text: str, budget: int, tokenizer: Dict) -> List[int]:
    """A served row's tokens: its text's bytes, then EOS where the row
    stopped before its budget (a row that fills its budget may end at
    the budget with no EOS slot left)."""
    data = list(text.encode("utf-8"))
    return data + [int(tokenizer["eos_id"])] if len(data) < budget else data


def decode_bytes(tokens: Sequence[int]) -> str:
    return bytes(t for t in tokens if 0 <= t < 256).decode("utf-8", errors="replace")
