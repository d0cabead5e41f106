"""The benchmark's own seeded weights.

Every leaf is drawn on the device from one ``torch.Generator`` seeded
with the run's ``--seed``, in bfloat16 (the type the weights are served
in), one call per kind of leaf for all layers at once: matrices ``N(0,
1/fan_in)``, the embedding ``N(0, 1/vocab)``, norm weights ``N(1,
0.1^2)``, the LM head ``N(0, (HEAD_SCALE)^2/hidden)``: near-flat logits, so
the sampled rows' lengths follow the grammar and the budget and not the
draw, and every seed serves the same mix of lengths.  The head's columns
of the blank bytes (those ``str.strip`` removes; token i < 256 is byte
i) are drawn ``BLANK_SCALE`` times smaller: on near-flat logits a greedy
row repeats the one byte its draw favours, and where that byte was a
blank, every string of the greedy game stripped to nothing, the game
rejected every decision and played each decide phase three times, so
that seed served more work than the others.  The same seed on the same card gives the same tensors, so the
reference draws them again after the program has been freed instead of
taking anything from it.  Leaves are named and laid out as the port's
weight tree is (``[in, out]`` matrices): the program and the reference
get the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

NORM_STD = 0.1
HEAD_SCALE = 0.1
BLANKS = (9, 10, 11, 12, 13, 28, 29, 30, 31, 32)
BLANK_SCALE = 0.01


def draw(model: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    D, F, L = model["hidden_size"], model["intermediate_size"], model["num_hidden_layers"]
    H, Hkv, dh, V = (model["num_attention_heads"], model["num_key_value_heads"],
                     model["head_dim"], model["vocab_size"])
    if model.get("tie_word_embeddings"):
        raise NotImplementedError("tied embeddings")
    if model.get("attention_bias"):
        raise NotImplementedError("attention biases")
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    bf16 = torch.bfloat16

    def normal(shape, mean, std):
        return torch.empty(shape, dtype=bf16, device=device).normal_(mean, std, generator=g)

    params = {"embed": normal((V, D), 0.0, 1.0 / math.sqrt(V))}
    for name, (n_in, n_out) in (("wq", (D, H * dh)), ("wk", (D, Hkv * dh)),
                                ("wv", (D, Hkv * dh)), ("wo", (H * dh, D)),
                                ("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D))):
        stacked = normal((L, n_in, n_out), 0.0, 1.0 / math.sqrt(n_in))
        for li in range(L):
            params[f"layers.{li}.{name}"] = stacked[li]
    for name, width in (("attn_norm", D), ("mlp_norm", D), ("q_norm", dh), ("k_norm", dh)):
        stacked = normal((L, width), 1.0, NORM_STD)
        for li in range(L):
            params[f"layers.{li}.{name}"] = stacked[li]
    params["final_norm"] = normal((D,), 1.0, NORM_STD)
    head = normal((D, V), 0.0, HEAD_SCALE / math.sqrt(D))
    head[:, list(BLANKS)] *= BLANK_SCALE
    params["lm_head"] = head
    return params

