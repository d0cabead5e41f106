"""GOOD: registry accessors; raw reads only of EXTERNAL names."""
import os

from bcg_tpu_torch.runtime.envflags import get_bool, get_int, get_str, is_set

TIMING = get_bool("BCG_TPU_TIMING")
BLOCKS = get_int("BCG_TPU_KV_POOL_BLOCKS")
KV_DTYPE = get_str("BCG_TPU_KV_DTYPE")
ALLOC = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "")  # external env: allowed
os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", "1")  # external env: allowed


def overridden():
    return is_set("BCG_TPU_CHECKPOINT_DIR")


def scenario_override():
    # Plain WRITES of registered names stay legal: harnesses configure
    # the flags they then read through the registry.
    os.environ["BCG_TPU_SPEC"] = "1"
    return get_bool("BCG_TPU_SPEC")
