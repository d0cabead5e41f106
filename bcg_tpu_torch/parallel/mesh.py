"""Device mesh construction — the port of ``bcg_tpu/parallel/mesh.py``.

Axes (the JAX package's names and order):

* ``dp`` — data parallel: independent batch rows / agent groups,
  replicated weights
* ``tp`` — tensor parallel: heads, the MLP's inner dim and the vocabulary
* ``sp`` — sequence parallel: the KV sequence over a ring

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
the world (one device a rank); each dimension's process group carries its
collectives (:mod:`bcg_tpu_torch.parallel.collectives`).  No mesh (``None``)
is the single-device engine: every axis has size 1.
"""

from __future__ import annotations

from typing import Dict, Sequence

AXES = ("dp", "tp", "sp")


def mesh_axes() -> Sequence[str]:
    return AXES


def build_mesh(dp: int = 1, tp: int = 1, sp: int = 1):
    """A ``(dp, tp, sp)`` DeviceMesh over the initialized world, whose
    size must equal the mesh's (one rank a device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    need = dp * tp * sp
    have = dist.get_world_size() if dist.is_initialized() else 1
    if need != have:
        raise ValueError(
            f"mesh dp={dp} tp={tp} sp={sp} needs a world of {need} ranks, have {have}"
            + ("" if dist.is_initialized() else " (torch.distributed is not initialized: "
               "start one rank per device, e.g. torchrun --nproc-per-node N)")
        )
    from bcg_tpu_torch.parallel import distributed

    return init_device_mesh(distributed.device().type, (dp, tp, sp), mesh_dim_names=AXES)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{"dp": …, "tp": …, "sp": …}`` (all 1 for ``None``), so ported code
    reads ``mesh_shape(mesh).get("tp", 1)`` as the JAX code reads
    ``mesh.shape``."""
    if mesh is None:
        return {a: 1 for a in AXES}
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_from_engine_config(engine_config):
    return build_mesh(
        dp=engine_config.data_parallel_size,
        tp=engine_config.tensor_parallel_size,
        sp=engine_config.sequence_parallel_size,
    )
