"""Largest decode-batch KV cache the engine allocated in the window
(``TorchEngine.max_kv_cache_bytes``, zeroed at window start), in 1e9
bytes."""

UNIT = "GB"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "KV cache (engine/torch_engine.py)"
MOVES = "peak_mem_gb"


def read(run):
    b = run.engine.get("max_kv_cache_bytes")
    return b / 1e9 if b else None
