"""Tools over the port, run as ``python -m bcg_tpu_torch.tools.<name>``:
diagnostics on a CUDA card, and the perf gate, the census gate and the
report runner on the CPU.  Nothing in the package imports them."""
