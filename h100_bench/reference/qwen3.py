"""Plain float32 Qwen3 forward pass: the reference that decides ``correct``.

It follows the published Qwen3 decoder (``Qwen3ForCausalLM``): token
embedding; per layer RMSNorm, q/k/v projections without bias, RMSNorm of
each q and k head (qk-norm), rotary positions (the rotate-half form,
``theta`` from the configuration), grouped-query causal attention, the
output projection and a residual; RMSNorm, the SwiGLU MLP (``silu(x Wg)
* (x Wu)``, then ``Wd``) and a residual; a final RMSNorm and the untied LM
head.  Every product is float32 with TF32 off, over each sequence whole
(no cache, no padding, no batching across sequences), layer by layer so
that only one layer's float32 weights exist at a time.

The weights are the benchmark's own draw (``h100_bench/weights.py``), by
the names that draw gives them (``[in, out]`` matrices, so ``x @ W``).
Where the configuration states int4 weights, the reference quantizes them
itself (:func:`int4_dequantized`).  ``control`` computes the same pass in
the next precision below the configuration's, as an fp8 serving path
would hold its tensors: every matrix-product input (activations, and the
weights where they are bf16) and the attention's queries, keys, values
and probabilities (as an fp8 attention kernel takes them) rounded to
float8 e4m3, each tensor with one absmax scale.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

LAYER_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
FP8_MAX = 448.0


def int4_dequantized(w: torch.Tensor, group: int) -> torch.Tensor:
    """The configuration's int4 weights of ``w`` ``[in, out]``, as float32:
    symmetric absmax per (group of ``group`` inputs, output), the scale
    ``absmax * float32(1/7)`` rounded to bfloat16, values
    ``clamp(round(w / scale), -8, 7)`` (round half to even)."""
    n_in, n_out = w.shape
    g = w.float().reshape(n_in // group, group, n_out)
    absmax = g.abs().amax(dim=1)
    scale = (absmax.clamp_min(1e-12) * torch.tensor(1.0 / 7.0, dtype=torch.float32)
             ).to(torch.bfloat16).float()
    q = torch.clamp(torch.round(g / scale[:, None, :]), -8, 7)
    return (q * scale[:, None, :]).reshape(n_in, n_out)


def fp8_round(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one absmax scale per slice along
    ``dim``, or one for the whole tensor (``dim`` None; the control's
    precision), returned in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
    scale = amax.clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0..T-1 on ``x`` ``[T, heads, Dh]`` (rotate half)."""
    T, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64, device=x.device) / dh))
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv[None]
    cos, sin = ang.cos().float()[:, None, :], ang.sin().float()[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, heads_per_chunk: int = 8,
              lower: Optional[Callable[[torch.Tensor], torch.Tensor]] = None) -> torch.Tensor:
    """Causal grouped-query attention of one sequence: ``q`` ``[T, H,
    Dh]``, ``k``/``v`` ``[T, Hkv, Dh]`` -> ``[T, H * Dh]``.  ``lower``
    rounds the probabilities before they weight ``v`` (the control)."""
    T, H, dh = q.shape
    group = H // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, heads_per_chunk):
        sl = slice(h0, h0 + heads_per_chunk)
        s = torch.einsum("thd,shd->hts", q[:, sl], k[:, sl]) / math.sqrt(dh)
        s = s.masked_fill(~causal, float("-inf"))
        probs = torch.softmax(s, dim=-1)
        if lower is not None:
            probs = lower(probs)
        out[:, sl] = torch.einsum("hts,shd->thd", probs, v[:, sl])
    return out.reshape(T, H * dh)


class Reference:
    """The reference model over the benchmark's weights.

    ``model``: the configuration's sizes (``hidden_size``,
    ``num_hidden_layers``, ``num_attention_heads``, ``num_key_value_heads``,
    ``head_dim``, ``rms_norm_eps``, ``rope_theta``); ``int4_group``: the
    group size where the configuration states int4 weights (None: the
    weights as drawn); ``control``: None or ``"fp8"``."""

    def __init__(self, params: Dict[str, torch.Tensor], model: Dict,
                 int4_group: Optional[int] = None, control: Optional[str] = None):
        if control not in (None, "fp8"):
            raise ValueError(f"control {control!r}")
        self.p = params
        self.m = model
        self.int4_group = int4_group
        self.control = control

    def _matrix(self, name: str) -> torch.Tensor:
        w = self.p[name]
        if self.int4_group:
            return int4_dequantized(w, self.int4_group)
        w = w.float()
        return fp8_round(w) if self.control == "fp8" else w

    def _lower(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x) if self.control == "fp8" else x

    def _linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._lower(x) @ w

    def logits(self, rows: Sequence[Tuple[Sequence[int], int]]) -> List[torch.Tensor]:
        """For each ``(tokens, first)``: float32 logits ``[len(tokens) -
        first, vocab]`` at positions ``first .. len(tokens) - 1``."""
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                return self._logits(rows)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    def _logits(self, rows):
        m, p = self.m, self.p
        H, Hkv, dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        eps, theta = float(m["rms_norm_eps"]), float(m["rope_theta"])
        dev = p["embed"].device
        xs = [p["embed"][torch.as_tensor(list(t), device=dev)].float() for t, _ in rows]
        for li in range(m["num_hidden_layers"]):
            pre = f"layers.{li}."
            w = {n: self._matrix(pre + n) for n in LAYER_MATRICES}
            norms = {n: p[pre + n].float() for n in ("attn_norm", "mlp_norm", "q_norm", "k_norm")}
            for i, x in enumerate(xs):
                T = x.shape[0]
                h = rms_norm(x, norms["attn_norm"], eps)
                q = self._linear(h, w["wq"]).reshape(T, H, dh)
                k = self._linear(h, w["wk"]).reshape(T, Hkv, dh)
                v = self._linear(h, w["wv"]).reshape(T, Hkv, dh)
                q = rope(rms_norm(q, norms["q_norm"], eps), theta)
                k = rope(rms_norm(k, norms["k_norm"], eps), theta)
                lo = self._lower
                att = attention(lo(q), lo(k), lo(v), lower=lo if self.control else None)
                x = x + self._linear(att, w["wo"])
                h = rms_norm(x, norms["mlp_norm"], eps)
                gate = torch.nn.functional.silu(self._linear(h, w["w_gate"]))
                xs[i] = x + self._linear(gate * self._linear(h, w["w_up"]), w["w_down"])
            del w
        head = self._matrix("lm_head")
        final = p["final_norm"].float()
        return [self._linear(rms_norm(x[first:], final, eps), head)
                for x, (_, first) in zip(xs, rows)]
