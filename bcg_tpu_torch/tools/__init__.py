"""One-off diagnostics of the port, run on a CUDA card (``python -m
bcg_tpu_torch.tools.<name>``); nothing in the package imports them."""
