"""Simulation runtime: orchestrator, metrics sinks, logging, checkpointing,
profiling (reference ``main.py``).

``BCGSimulation`` is exported lazily (PEP 562) so light consumers can
import runtime submodules without loading torch.
"""

__all__ = ["BCGSimulation"]


def __getattr__(name: str):
    if name == "BCGSimulation":
        from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

        return BCGSimulation
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
