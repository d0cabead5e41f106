"""Inference engines of the PyTorch port.

:class:`bcg_tpu_torch.engine.torch_engine.TorchEngine` serves every
agent's guided decision and vote on an NVIDIA card (or, when asked, the
CPU) behind the same :class:`InferenceEngine` contract as the JAX
package's ``JaxEngine``.
"""

from bcg_tpu_torch.engine.interface import GenerationRequest, InferenceEngine, create_engine

__all__ = ["InferenceEngine", "GenerationRequest", "create_engine"]
