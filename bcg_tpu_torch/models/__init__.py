"""Decoder-only transformer family (RMSNorm + RoPE + GQA + SwiGLU) in
PyTorch, over a flat parameter dict keyed by ``param_plan``'s logical
names."""

from bcg_tpu_torch.models.configs import MODEL_SPECS, ModelSpec, spec_for_model

__all__ = ["ModelSpec", "MODEL_SPECS", "spec_for_model"]
