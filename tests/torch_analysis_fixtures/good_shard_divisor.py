"""GOOD: per-rank accounting through the engaged-axes helpers."""
from bcg_tpu_torch.parallel.sharding import kv_cache_bytes_per_device, tree_bytes_per_device


def kv_bytes_per_rank(mesh, shapes):
    return kv_cache_bytes_per_device(mesh, shapes)


def tree_bytes_per_rank(tree, pending, prompts):
    # Division by other lengths is fine.
    share = len(pending) / len(prompts)
    return tree_bytes_per_device(tree), share
