"""GOOD: accessors with registered names only."""
from bcg_tpu_torch.config import env_flag
from bcg_tpu_torch.runtime import envflags

A = envflags.get_bool("BCG_TPU_TIMING")
B = env_flag("BCG_TPU_FINE_SUFFIX")
