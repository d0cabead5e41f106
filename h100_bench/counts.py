"""Operations and bytes the window's requests need, from the model's
published sizes alone (so no implementation choice moves them), and the
table of the card's published peaks.

A request is one served row: ``prompt`` tokens in, ``served`` tokens out
(its EOS included where it emitted one).  Its forward passes take
``prompt + served - 1`` tokens (the last served token is never fed) and
produce ``served`` rows of logits.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full
# 700 W power limit.
PEAKS = {
    "H100 HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> Optional[Dict[str, float]]:
    """The published peaks of a card by its name (the SXM H100 reports
    ``NVIDIA H100 80GB HBM3``), or None for a card not in the table."""
    if "H100" in device_name and "HBM3" in device_name:
        return PEAKS["H100 HBM3"]
    return None


def layer_matmul_params(m: Dict) -> int:
    """Weights of one decoder layer's matrix products."""
    D, F = m["hidden_size"], m["intermediate_size"]
    q, kv = m["num_attention_heads"] * m["head_dim"], m["num_key_value_heads"] * m["head_dim"]
    return D * q + 2 * D * kv + q * D + 3 * D * F


def request_flops(m: Dict, prompt: int, served: int) -> float:
    """Operations of one request: 2 per weight of every layer product for
    each fed token, the LM head for each logits row, and attention (QK^T
    and PV, 2 operations each per query head, head dimension and key) over
    each fed token's causal context."""
    fed = prompt + served - 1
    L = m["num_hidden_layers"]
    mm = 2.0 * L * layer_matmul_params(m) * fed
    head = 2.0 * m["hidden_size"] * m["vocab_size"] * served
    attn = 4.0 * L * m["num_attention_heads"] * m["head_dim"] * fed * (fed + 1) / 2
    return mm + head + attn


def decode_kv_bytes(m: Dict, prompt: int, served: int, kv_bytes_per_value: float) -> float:
    """K and V bytes the request's decode steps must read: step ``i``
    (``i = 0 .. served - 2``; the first token comes from the prefill)
    attends over ``prompt + i + 1`` positions, every layer and kv head."""
    steps = max(served - 1, 0)
    positions = steps * prompt + steps * (steps + 1) / 2
    per_position = (2 * m["num_hidden_layers"] * m["num_key_value_heads"] * m["head_dim"]
                    * kv_bytes_per_value)
    return positions * per_position


def int4_bytes(weights: int, group: int) -> float:
    """Bytes of ``weights`` int4 weights with a bf16 scale per ``group``."""
    return weights / 2 + weights / group * 2


def int4_pass_bytes(m: Dict, group: int) -> float:
    """Bytes of every int4 weight and bf16 group scale of one forward
    pass: the layers' matrix products and the LM head."""
    D, V = m["hidden_size"], m["vocab_size"]
    return int4_bytes(m["num_hidden_layers"] * layer_matmul_params(m) + D * V, group)


def int4_head_bytes(m: Dict, group: int) -> float:
    """Bytes of the int4 LM head and its bf16 group scales."""
    return int4_bytes(m["hidden_size"] * m["vocab_size"], group)
