"""Hand-written Hopper kernels and their plain PyTorch versions: flash
prefill attention, bf16 decode attention, the fused guided sampler."""
