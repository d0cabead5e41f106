"""BAD: accessors called with names the PORT's registry does not know
(4 findings): a typo, an unknown name, and two of the five TPU-only
flags of the JAX package's registry that the port leaves out on
purpose."""
from bcg_tpu_torch.config import env_flag
from bcg_tpu_torch.runtime import envflags

A = envflags.get_bool("BCG_TPU_TIMNIG")                     # BCG-ENV-UNREG (typo)
B = env_flag("BCG_TPU_NO_SUCH_FLAG")                        # BCG-ENV-UNREG
C = envflags.get_str("BCG_TPU_XLA_CACHE")                   # BCG-ENV-UNREG (TPU-only)
D = envflags.get_bool("BCG_TPU_DISABLE_INT8_DECODE_KERNEL")  # BCG-ENV-UNREG (TPU-only)
