"""BAD: raw environment reads of registered flag names (6 findings)."""
import os

TIMING = os.environ.get("BCG_TPU_TIMING", "") not in ("", "0")  # BCG-ENV-RAW
VERBOSE = os.getenv("VERBOSE") == "1"                           # BCG-ENV-RAW
DIR = os.environ["BCG_TPU_CHECKPOINT_DIR"]                      # BCG-ENV-RAW
# A TPU-only flag of the JAX package: the port's registry leaves it out,
# and a raw read of it is a finding all the same.
CACHE = os.environ.get("BCG_TPU_XLA_CACHE")                     # BCG-ENV-RAW


def overridden():
    return "BCG_TPU_PAGED_KV" in os.environ                     # BCG-ENV-RAW


def sticky_default():
    return os.environ.setdefault("BCG_TPU_SPEC", "1")           # BCG-ENV-RAW
