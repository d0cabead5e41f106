"""Abstract boot smoke: boot every model preset — 14B and 32B included —
through the port's weight layout and memory accounting under the port's
meshes, without making a single weight: the counterpart of
``scripts/boot_smoke.py``.

    python -m bcg_tpu_torch.tools.boot_smoke

The shapes come from ``models/transformer.param_plan`` (quantized parts
from ``models/convert._quantized_shapes``), each leaf a ``meta`` tensor
that ``parallel/sharding.shard_leaf`` slices as it slices a rank's real
leaf; the meshes are :class:`ShapeMesh` stand-ins that carry what
``parallel/mesh.mesh_shape`` reads (``mesh_dim_names`` and
``mesh.shape``) and rank 0's coordinates.  Meshes: one device, tp 8,
dp 8 and dp 2 x tp 2 x sp 2; quantizations by size class, as the JAX
smoke's.  Checks, per (preset, mesh, quantization):

1. every leaf and quantized part places: the part ``shard_leaf`` keeps is
   the plan's shape with the split dim divided by tp, and a leaf whose
   split dim does not divide tp (the port's guard would keep it whole on
   every rank) is named;
2. the boot peak obeys the PORT's contract, which is not the JAX
   package's: a rank draws each full leaf and then slices it
   (``models/loader.init_random_params_sharded``), so
   ``loader.boot_peak_report`` must lie between the final tree and the
   final tree plus the largest full-leaf transient;
3. under tp, every large 2-D leaf's final form is a shard;
4. ``parallel/sharding.kv_cache_bytes_per_device`` summed over the mesh
   equals the global cache bytes times the replication of the axes that
   did not engage, for engaged, dp-bypass and guard-failing caches
   (B, S) = (8, 1024), (3, 1024) and (8, 1021, int8).

Prints one status line per combination; exits 1 on any problem.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bcg_tpu_torch.parallel.mesh import AXES

# A 2-D dense leaf of at least this many elements is "large" (check 3):
# wq, w_gate and the vocabulary leaves of every flagship preset.
LARGE_LEAF_ELEMS = 1 << 24
# The dtype each quantized part is stored in.
_PART_DTYPES = {"q": torch.int8, "scale": torch.float32, "q4": torch.int8,
                "gscale": torch.bfloat16}
KV_CASES = ((8, 1024, False), (3, 1024, False), (8, 1021, "int8"))


class ShapeMesh:
    """A shape-only stand-in for a ``(dp, tp, sp)`` DeviceMesh: its axis
    names, its shape (``mesh.shape``, a meta tensor's) and rank 0's
    coordinates."""

    def __init__(self, dp: int = 1, tp: int = 1, sp: int = 1):
        self.mesh_dim_names = AXES
        self.mesh = torch.empty((dp, tp, sp), device="meta")

    def size(self) -> int:
        return int(np.prod(self.mesh.shape))

    def get_local_rank(self, axis: str) -> int:
        return 0


MESHES = (("single", None), ("tp8", ShapeMesh(tp=8)), ("dp8", ShapeMesh(dp=8)),
          ("dp2tp2sp2", ShapeMesh(dp=2, tp=2, sp=2)))


def quantizations(spec) -> List[Optional[str]]:
    """The JAX smoke's per-size-class quantizations, plus bf16 where the
    bench serves it."""
    from bcg_tpu_torch.models.configs import LARGE_MODEL_PARAMS, XL_MODEL_PARAMS

    if spec.param_count >= XL_MODEL_PARAMS:
        return ["int4", "int8"]
    if spec.param_count >= LARGE_MODEL_PARAMS:
        return ["int8", None]
    return [None, "int8"]


def _meta_leaf(name: str, kind: str, shape, quantization: Optional[str]):
    """A plan leaf as the port makes it, on ``meta``: bf16, or the
    quantized parts of a weight the quantizer takes."""
    from bcg_tpu_torch.models.convert import _quantized_shapes
    from bcg_tpu_torch.models.quantize import is_quant_leaf

    if kind == "dense" and quantization is not None and is_quant_leaf(name):
        parts = ("q", "scale") if quantization == "int8" else ("q4", "gscale")
        return {p: torch.empty(s, dtype=_PART_DTYPES[p], device="meta")
                for p, s in _quantized_shapes(parts, shape).items()}
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


def _tp(mesh) -> int:
    from bcg_tpu_torch.parallel.mesh import mesh_shape

    return mesh_shape(mesh)["tp"]


def place(spec, mesh, quantization) -> Tuple[Dict[str, Tuple], List[str]]:
    """Check 1: each plan leaf's (and part's) final shape on rank 0, and
    the problems."""
    from bcg_tpu_torch.models.transformer import param_plan
    from bcg_tpu_torch.parallel.sharding import leaf_dim, shard_leaf

    tp = _tp(mesh)
    # The split dims the layout table names, with only the head guards
    # (shared with the JAX package) applied: where the port's extra guards
    # (vocabulary, MLP) replicate instead, the leaf does not place.
    planned = dataclasses.replace(spec, vocab_size=tp, intermediate_size=tp)
    finals, problems = {}, []
    for name, kind, shape in param_plan(spec):
        leaf = _meta_leaf(name, kind, shape, quantization)
        try:
            out = shard_leaf(name, leaf, spec, mesh, shape) if mesh is not None else leaf
        except Exception as e:  # noqa: BLE001 - reported by leaf, not raised
            problems.append(f"{spec.name}: {name} {tuple(shape)} does not place under tp={tp}: "
                            f"{type(e).__name__}: {e}")
            continue
        parts = out.items() if isinstance(out, dict) else [(None, out)]
        fulls = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
        for (part, got), (_, full) in zip(parts, fulls):
            sub = name if part is None else f"{name}.{part}"
            dim = leaf_dim(sub, spec, tp)
            want = list(full.shape)
            if dim is not None:
                want[dim] //= tp
            finals[sub] = (tuple(got.shape), got.dtype)
            if list(got.shape) != want:
                problems.append(f"{spec.name}: {sub} places as {tuple(got.shape)}, expected "
                                f"{tuple(want)} under tp={tp}")
            plan_dim = leaf_dim(sub, planned, tp)
            if plan_dim is not None and dim is None:
                problems.append(f"{spec.name}: {sub} {tuple(full.shape)} does not place: dim "
                                f"{plan_dim} ({full.shape[plan_dim]}) does not divide tp={tp}, "
                                "so every rank would hold it whole")
    return finals, problems


def _bytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch.empty((), dtype=dtype).element_size()


def check_preset(name: str, mesh, quantization) -> List[str]:
    """Every boot-path inconsistency of one (preset, mesh, quantization);
    empty when the abstract boot is sound."""
    from bcg_tpu_torch.models.configs import MODEL_SPECS
    from bcg_tpu_torch.models.loader import boot_peak_report
    from bcg_tpu_torch.models.transformer import init_kv_cache, param_plan
    from bcg_tpu_torch.parallel.mesh import mesh_shape
    from bcg_tpu_torch.parallel.sharding import kv_cache_bytes_per_device, kv_cache_layout

    spec = MODEL_SPECS[name]
    finals, problems = place(spec, mesh, quantization)
    if problems:
        return problems

    # 2. the port's boot-peak contract.
    report = boot_peak_report(spec, mesh, quantization)
    final, peak = report["final_bytes_per_device"], report["peak_bytes_per_device"]
    if sum(_bytes(*f) for f in finals.values()) != final:
        problems.append(f"{name}: boot_peak_report's final tree {final} bytes is not the "
                        f"placed leaves' {sum(_bytes(*f) for f in finals.values())}")
    if not final <= peak <= final + report["max_init_transient_bytes"]:
        problems.append(f"{name}: boot peak {peak} outside [final tree {final}, final tree + "
                        f"the largest full-leaf transient {report['max_init_transient_bytes']}]")

    # 3. under tp, large 2-D leaves end as shards.
    tp = _tp(mesh)
    if tp > 1:
        for leaf_name, kind, shape in param_plan(spec):
            if kind != "dense" or len(shape) != 2 or int(np.prod(shape)) < LARGE_LEAF_ELEMS:
                continue
            main = leaf_name if leaf_name in finals else next(
                f"{leaf_name}.{p}" for p in ("q", "q4") if f"{leaf_name}.{p}" in finals)
            got = finals[main][0]
            full = (shape if main == leaf_name
                    else _meta_leaf(leaf_name, kind, shape, quantization)[main.rsplit(".", 1)[1]].shape)
            if int(np.prod(got)) * tp != int(np.prod(full)):
                problems.append(f"{name}: {main} {tuple(full)} is whole on every rank under "
                                f"tp={tp} (final {tuple(got)})")

    # 4. KV accounting: per-rank bytes summed over the mesh = global bytes
    # times the replication of the axes that did not engage.
    if mesh is not None:
        ms = mesh_shape(mesh)
        for B, S, quant in KV_CASES:
            cache = init_kv_cache(spec, B, S, device="meta", quantized=quant)
            leaves = [(tuple(t.shape), t.dtype) for entry in cache for t in entry.values()]
            per_dev = kv_cache_bytes_per_device(mesh, leaves, quantized=quant)
            want = 0
            for shape, dtype in leaves:
                engaged = 1
                for d, ax in zip(shape, kv_cache_layout(quant, len(shape))):
                    if ax is not None and ms[ax] > 1 and d % ms[ax] == 0:
                        engaged *= ms[ax]
                want += _bytes(shape, dtype) * (mesh.size() // engaged)
            if per_dev * mesh.size() != want:
                problems.append(f"{name}: kv_cache_bytes_per_device(B={B}, S={S}, {quant or 'bf16'})"
                                f" x {mesh.size()} ranks = {per_dev * mesh.size()}, global bytes "
                                f"x replication = {want}")
    return problems


def combinations(meshes: Sequence = MESHES):
    """Every (preset, mesh name, mesh, quantization) the smoke boots."""
    from bcg_tpu_torch.models.configs import MODEL_SPECS

    for name, spec in sorted(MODEL_SPECS.items()):
        for mesh_name, mesh in meshes:
            for quant in quantizations(spec):
                yield name, mesh_name, mesh, quant


def run_all(verbose: bool = True) -> List[str]:
    problems = []
    for name, mesh_name, mesh, quant in combinations():
        got = check_preset(name, mesh, quant)
        problems += got
        if verbose:
            print(f"boot_smoke: {name:45s} mesh={mesh_name:10s} quant={str(quant):5s} "
                  f"{'FAIL' if got else 'ok'}", flush=True)
    return problems


def main(argv=None) -> int:
    problems = run_all()
    if problems:
        print(f"\nboot_smoke: {len(problems)} problem(s):")
        for p in problems:
            print(f"  - {p}")
        return 1
    print("boot_smoke: all presets abstract-boot cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
