"""The benchmark of the PyTorch/H100 port (``bcg_tpu_torch``): see
``run.py`` for a run, ``registry.py`` for how a cell's configuration,
traffic mix and metrics are found by name, and ``reference/`` for the
plain reference that decides ``correct``."""
