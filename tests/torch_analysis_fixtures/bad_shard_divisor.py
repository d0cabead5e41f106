"""BAD: per-rank accounting divided by raw device or rank counts."""
import torch
import torch.distributed as dist

from bcg_tpu_torch.parallel import distributed


def kv_bytes_per_rank(total_bytes, mesh):
    return total_bytes / mesh.size()                  # BCG-SHARD-DIVISOR


def tree_bytes_per_rank(total_bytes):
    per = total_bytes // dist.get_world_size()        # BCG-SHARD-DIVISOR
    return per + total_bytes / torch.cuda.device_count()  # BCG-SHARD-DIVISOR


def rows_per_rank(rows, device_ids):
    return rows // distributed.world_size() + rows // len(device_ids)  # BCG-SHARD-DIVISOR x2
