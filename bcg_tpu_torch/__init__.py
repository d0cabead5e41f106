"""bcg_tpu_torch — the Byzantine Consensus Game on PyTorch and CUDA.

The PyTorch/H100 port of :mod:`bcg_tpu`.  It mirrors the JAX package's
layout (``models/transformer.py``, ``ops/attention.py``,
``engine/torch_engine.py`` beside ``engine/jax_engine.py``, ...) and
imports nothing from it: the framework-free host layers (config, game,
comm, agents, scenarios, the guided-decoding compiler) are copies, and
every Pallas kernel on the served path is a hand-written CUDA kernel
under ``csrc/`` with a plain PyTorch version beside its wrapper.
"""
