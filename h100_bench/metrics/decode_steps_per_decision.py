"""Decode steps the engine ran in the window (``TorchEngine
.total_decode_steps``) per agent decision: what merging, fast-forward or
speculation cut."""

UNIT = "steps/decision"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "engine decode loops (engine/torch_engine.py)"
MOVES = "decisions_per_s"


def read(run):
    return run.engine["decode_steps"] / run.decisions if run.decisions else None
