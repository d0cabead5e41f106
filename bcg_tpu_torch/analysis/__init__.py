"""Static checker over the PyTorch port (``bcg_tpu_torch``).

The port's copy of ``bcg_tpu/analysis``: an AST analyzer run over
``bcg_tpu_torch/`` and ``chip_smoke.py`` as a tier-1 test
(``tests/test_torch_analysis.py``) and standalone as ``python -m
bcg_tpu_torch.analysis``.  It imports neither JAX nor the JAX package.

Rule catalog (the JAX package's stable IDs):

* ``BCG-HOST-SYNC``     host read inside a **capture region**: the code
                        a CUDA graph of the decode step or fused round
                        records (``core.CAPTURE_ROOTS`` and callees) —
                        ``.item()``, ``.tolist()``, ``.cpu()``,
                        ``.numpy()``, ``torch.cuda.synchronize``,
                        ``bool()``/``int()`` of a tensor, a tensor in a
                        Python ``if``/``while``, ``torch.nonzero``,
                        boolean-mask indexing, ``np.asarray``; calls
                        inside ``with obs_hostsync.expected():`` (the
                        runtime audit's seams) are exempt
* ``BCG-JIT-NP``        other ``np.*`` calls inside a capture region
* ``BCG-JIT-BRANCH``    Python ``if``/``while`` on a non-defaulted
                        parameter of a capture root
* ``BCG-ENV-RAW``       raw ``os.environ`` read of a registered flag name
                        outside ``runtime/envflags.py``
* ``BCG-ENV-UNREG``     ``envflags`` accessor call with a flag name the
                        PORT's registry does not hold (it leaves out the
                        JAX package's TPU-only flags on purpose)
* ``BCG-EXCEPT-BROAD``  ``except Exception`` that neither re-raises,
                        logs, nor inspects the exception
* ``BCG-MUT-DEFAULT``   mutable default argument values
* ``BCG-LOCK-CALL``     engine dispatch lexically inside a ``with lock:``
                        body
* ``BCG-TIME-WALL``     ``time.time()`` in duration arithmetic (around
                        CUDA work it times the launches, not the work)
* ``BCG-RETRY-SLEEP``   fixed-interval retry sleeps where backoff is
                        expected
* ``BCG-OBS-NAME``      observability metric names outside the
                        registered namespaces
* ``BCG-OBS-BUCKET``    histogram bucket lists drifting from the shared
                        bound constants
* ``BCG-SHARD-AXIS``    a string literal used as a mesh axis (a
                        collective's ``axis``, ``get_group``,
                        ``get_local_rank``, a ``mesh_shape`` key) that is
                        not one of ``parallel/mesh.AXES``
* ``BCG-SHARD-DIVISOR`` a division by a raw device or rank count
                        (``mesh.size()``, ``dist.get_world_size()``,
                        ``torch.cuda.device_count()``, ``len`` of a
                        device list) where per-rank bytes need the
                        engaged axes (``parallel/sharding``'s helpers)
* ``BCG-JIT-OUTSHARD``  in ``models/``/``parallel/``, a full freshly
                        made tensor stored into a mesh function's tree
                        without ``shard_leaf``

Whole-program rules (``interproc.py``): ``BCG-LOCK-ORDER``,
``BCG-LOCK-BLOCK``, ``BCG-SHARED-MUT``.  The same pass lifts capture
regions across module boundaries (``propagate_capture_regions``).

The JAX package's BCG-JIT-DONATE is not a rule here: torch has no
buffer donation (``rules.py``'s docstring says why, and what holds the
boot peak instead).

Suppression: the port's baseline (``bcg_tpu_torch/analysis/
baseline.json``) parks deliberate findings with a one-line
justification each (a BCG-HOST-SYNC entry also names the runtime seam
that counts it); ``# lint: ignore[RULE-ID]`` suppresses inline.
"""

from bcg_tpu_torch.analysis.core import (
    CAPTURE_ROOTS,
    AnalysisResult,
    CaptureRoot,
    Finding,
    analyze_paths,
    default_paths,
    load_baseline,
    repo_root,
)
from bcg_tpu_torch.analysis.rules import ALL_RULES, RULE_IDS

__all__ = [
    "ALL_RULES",
    "CAPTURE_ROOTS",
    "RULE_IDS",
    "AnalysisResult",
    "CaptureRoot",
    "Finding",
    "analyze_paths",
    "default_paths",
    "load_baseline",
    "repo_root",
]
