"""Weight and KV-cache layouts over the mesh (Megatron-style tensor
parallelism) — the port of ``bcg_tpu/parallel/sharding.py``.

The JAX package names a ``PartitionSpec`` per leaf and lets XLA place the
shards and insert the collectives.  Here each rank holds plain local
tensors: :data:`_SPECS` names the ONE dimension of each leaf that splits
over ``tp`` (the JAX specs' only sharded axis), :func:`shard_params` keeps
this rank's slice of every leaf, and the model calls the collectives that
layout implies (``models/transformer.py``).

* Column-parallel in-projections (wq/wk/wv/w_gate/w_up and their biases)
  split their OUTPUT dim; row-parallel out-projections (wo/w_down) split
  their INPUT dim; the embedding splits its vocabulary rows and the LM
  head its vocabulary columns; norms replicate.
* Guards, as in the JAX package: heads that do not divide ``tp``
  replicate (q heads: wq/wo/bq; kv heads: wk/wv/bk/bv); an int8 ``scale``
  follows its weight's output dim (replicated for a row-parallel parent:
  its absmax runs over ALL input rows, as one device's does).  Where XLA
  would pad an indivisible dim, the port replicates the leaf instead (the
  vocabulary and the MLP's inner dim).
* Quantized leaves keep the one-device tree's values (GSPMD's global
  semantics): each rank's parts are slices of the one-device quantized
  leaf.  A column-parallel int4 parent slices its output columns.  A
  row-parallel one (``wo``, ``w_down``) takes the CONTIGUOUS slice of the
  unpacked input rows its activations hold, repacked locally (local rows
  ``i`` and ``i + K_local/2`` in one byte, :func:`repack_int4_rows`) —
  where XLA splits the packed rows, which would hand a rank global rows
  ``i`` and ``i + K/2`` — and the ``gscale`` rows of exactly its groups
  (the group is the full leaf's; a group that straddles two ranks, at the
  tiny widths, is repeated to smaller groups of the same scale).
* KV caches: batch over ``dp``, sequence over ``sp``, kv heads over
  ``tp``, each axis only where it divides (else replicated); a paged
  pool splits kv heads only, and its block table replicates.
* Byte accounting (:func:`kv_cache_bytes_per_device`,
  :func:`tree_bytes_per_device`) divides by the axes that engage, never by
  the world size.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bcg_tpu_torch.models.configs import ModelSpec
from bcg_tpu_torch.parallel.mesh import mesh_shape

# Logical leaf name (last path component) -> the dim split over tp (None:
# replicated).  Shapes are the plan's ``[in, out]`` / ``[V, D]``.
_SPECS = {
    "embed": 0,
    "final_norm": None,
    "lm_head": 1,
    "attn_norm": None,
    "mlp_norm": None,
    "wq": 1, "wk": 1, "wv": 1, "w_gate": 1, "w_up": 1,
    "wo": 0, "w_down": 0,
    "q_norm": None, "k_norm": None,
    "bq": 0, "bk": 0, "bv": 0,
}
_QUANT_PARTS = ("q", "scale", "q4", "gscale")


def _tp(mesh) -> int:
    return mesh_shape(mesh).get("tp", 1)


def leaf_dim(logical_name: str, spec: ModelSpec, tp: int) -> Optional[int]:
    """The dim of a plan leaf (``layers.3.wq``; a quantized part
    ``layers.3.wq.scale``) that splits over ``tp`` in its logical shape,
    or None when it replicates (the guards above)."""
    parts = logical_name.split(".")
    leaf, quant = parts[-1], None
    if leaf in _QUANT_PARTS and len(parts) >= 2 and parts[-2] in _SPECS:
        leaf, quant = parts[-2], parts[-1]
    dim = _SPECS.get(leaf)
    if tp <= 1 or dim is None:
        return None
    if leaf in ("wq", "wo", "bq") and spec.num_heads % tp:
        return None
    if leaf in ("wk", "wv", "bk", "bv") and spec.num_kv_heads % tp:
        return None
    if leaf in ("embed", "lm_head") and spec.vocab_size % tp:
        return None
    if leaf in ("w_gate", "w_up", "w_down") and spec.intermediate_size % tp:
        return None
    out_dim = 0 if leaf in ("bq", "bk", "bv") else 1
    if quant == "scale":
        # Per-output-channel vector [out]: sharded with a column-parallel
        # parent, replicated with a row-parallel one.
        return 0 if dim == out_dim else None
    if quant == "gscale":
        # [in/group, out]: a column-parallel parent's output columns, a
        # row-parallel parent's own groups.
        return 1 if dim == out_dim else 0
    return dim


def _slice(t: torch.Tensor, dim: Optional[int], tp: int, r: int, full: int) -> torch.Tensor:
    """Rank ``r``'s slice of ``t`` along ``dim`` (of logical extent
    ``full``); a leaf already at the slice's extent is kept as it is, so
    sharding is idempotent."""
    if dim is None or t.shape[dim] != full:
        return t
    n = full // tp
    return t.narrow(dim, r * n, n)


def _owned(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A slice copied out of its source (so the full leaf can be freed),
    in the source's layout (the quantized weights' output-major order)."""
    if t.data_ptr() == like.data_ptr() and t.shape == like.shape:
        return t
    out_major = like.dim() == 2 and like.stride(0) == 1 and like.shape[1] > 1
    return t.t().contiguous().t() if out_major else t.contiguous()


def shard_leaf(name: str, leaf, spec: ModelSpec, mesh, full_shape: Tuple[int, ...]):
    """This rank's slice of one plan leaf (a tensor, or a quantized dict
    of parts) whose unsharded logical shape is ``full_shape``."""
    tp = _tp(mesh)
    r = mesh.get_local_rank("tp") if tp > 1 else 0
    if isinstance(leaf, dict):
        out = {}
        for part, t in leaf.items():
            dim = leaf_dim(f"{name}.{part}", spec, tp)
            if dim is None:
                out[part] = t
                continue
            full = _part_extent(part, dim, full_shape)
            if part == "q4" and dim == 0:
                out[part] = _row_slice_int4(t, tp, r, full)
            elif part == "gscale" and dim == 0:
                out[part] = _row_slice_groups(t, tp, r, full, full_shape[0])
            else:
                out[part] = _owned(_slice(t, dim, tp, r, full), t)
        return out
    dim = leaf_dim(name, spec, tp)
    if dim is None:
        return leaf
    return _owned(_slice(leaf, dim, tp, r, full_shape[dim]), leaf)


def repack_int4_rows(rows: torch.Tensor) -> torch.Tensor:
    """Unpacked int4 values ``[K, N]`` (int8 in [-8, 7]) packed two a byte
    along the contraction axis, rows ``i`` and ``i + K/2`` in one byte
    (``models/quantize.py``'s packing), output-major as the B5 kernel
    takes them."""
    half = rows.shape[0] // 2
    packed = ((rows[:half] & 0x0F) | (rows[half:] << 4)).to(torch.int8)
    return packed.t().contiguous().t()


def _row_slice_int4(q4: torch.Tensor, tp: int, r: int, full: int) -> torch.Tensor:
    """Rank ``r``'s contiguous ``1/tp`` of a row-parallel int4 weight's
    unpacked input rows, repacked locally; a leaf already at the local
    extent is kept (idempotent)."""
    from bcg_tpu_torch.ops.w4_matmul import unpack_int4

    if q4.shape[0] != full:
        return q4
    rows = unpack_int4(q4)
    n = rows.shape[0] // tp
    if n % 2:
        raise ValueError(f"int4 row-parallel slice of {n} rows cannot be packed in pairs")
    return repack_int4_rows(rows.narrow(0, r * n, n))


def _row_slice_groups(gscale: torch.Tensor, tp: int, r: int, groups: int,
                      d_in: int) -> torch.Tensor:
    """The scales of rank ``r``'s contiguous ``d_in / tp`` input rows of a
    row-parallel int4 weight of ``groups`` groups: its own group rows when
    the groups divide its rows, else each group row repeated to groups of
    ``gcd(group, d_in / tp)`` rows (a group straddling two ranks), so that
    every local row reads its own scale.  A leaf already at the local
    extent is kept."""
    if gscale.shape[0] != groups:
        return gscale
    g, n = d_in // groups, d_in // tp
    g_loc = math.gcd(g, n)
    if g_loc != g:
        gscale = gscale.repeat_interleave(g // g_loc, dim=0)
    per = n // g_loc
    return gscale.narrow(0, r * per, per).contiguous()


def _part_extent(part: str, dim: int, full_shape) -> int:
    """The unsharded extent of a quantized part's split dim: ``q``/``q4``
    split their parent's dim (``q4``'s input dim in packed rows),
    ``scale`` its output, ``gscale`` its parent's output or (row-parallel)
    the full leaf's groups, whose group divides this rank's rows."""
    d_in, d_out = full_shape
    if part == "scale":
        return d_out
    if part == "q4" and dim == 0:
        return d_in // 2
    if part == "gscale" and dim == 0:
        from bcg_tpu_torch.models.quantize import int4_group_for

        return d_in // int4_group_for(d_in)
    return (d_in, d_out)[dim]


def shard_params(params: Dict, spec: ModelSpec, mesh, quantize=None) -> Dict:
    """This rank's slice of every leaf of a flat parameter dict (full or
    already sharded leaves; a size-1 ``tp`` keeps everything).
    ``quantize(full leaf) -> quantized dict``: applied to each full bf16
    dense weight BEFORE it is sliced (the sharded quantizer's order, so
    the slices are the one-device quantized tree's), one leaf at a time."""
    from bcg_tpu_torch.models.quantize import is_quant_leaf
    from bcg_tpu_torch.models.transformer import param_plan

    plan = {n: tuple(shape) for n, _, shape in param_plan(spec)}
    if spec.tie_embeddings and "lm_head" in params:
        plan["lm_head"] = (spec.hidden_size, spec.vocab_size)
    out = {}
    for n, leaf in params.items():
        if quantize is not None and is_quant_leaf(n) and not isinstance(leaf, dict):
            leaf = quantize(leaf)
        out[n] = shard_leaf(n, leaf, spec, mesh, plan[n])
    return out


def local_heads(spec: ModelSpec, tp: int) -> Tuple[int, int]:
    """(q heads, kv heads) a rank computes under ``tp`` (the guards'
    replicated counts where they do not divide)."""
    h = spec.num_heads // tp if spec.num_heads % tp == 0 else spec.num_heads
    hkv = spec.num_kv_heads // tp if spec.num_kv_heads % tp == 0 else spec.num_kv_heads
    return h, hkv


# ------------------------------------------------------------------ caches

def _engaged(mesh, axes: Sequence[Optional[str]], shape) -> Tuple[Optional[str], ...]:
    """Each axis of a cache leaf's layout that engages: named, of mesh
    size > 1, and dividing the leaf's dim (else replicated)."""
    ms = mesh_shape(mesh)
    return tuple(
        ax if ax is not None and ms.get(ax, 1) > 1 and shape[i] % ms[ax] == 0 else None
        for i, ax in enumerate(axes)
    )


def kv_cache_layout(quantized=False, leaf_ndim: int = 4) -> Tuple[Optional[str], ...]:
    """The mesh axis of each dim of a dense cache leaf: bf16 k/v ``[B, S,
    Hkv, Dh]``; quantized k/v ``[B, Hkv, S, Dh]`` and scales ``[B, Hkv,
    S]``."""
    if quantized:
        return ("dp", "tp", "sp", None)[:leaf_ndim]
    return ("dp", "sp", "tp", None)


def local_shape(mesh, axes, shape) -> Tuple[int, ...]:
    """A leaf's shape on one rank under ``axes`` (guarded by
    :func:`_engaged`)."""
    ms = mesh_shape(mesh)
    return tuple(d // ms[ax] if ax is not None else d
                 for d, ax in zip(shape, _engaged(mesh, axes, shape)))


def paged_pool_layout(quantized=False, leaf_ndim: int = 4) -> Tuple[Optional[str], ...]:
    """A paged pool leaf: kv heads over ``tp`` only (every rank must read
    any block); bf16 ``[N, bs, Hkv, Dh]``, quantized ``[N, Hkv, bs, Dh]``
    and scales ``[N, Hkv, bs]``.  The block table replicates."""
    if quantized:
        return (None, "tp", None, None)[:leaf_ndim]
    return (None, None, "tp", None)


def shard_bytes(shape, dtype, mesh=None, axes=None) -> int:
    """Bytes of ONE rank's shard of an array (full bytes without a mesh
    or layout) — the one shard-size computation behind every per-device
    memory guard."""
    dims = shape if mesh is None or axes is None else local_shape(mesh, axes, shape)
    itemsize = (torch.empty((), dtype=dtype).element_size() if isinstance(dtype, torch.dtype)
                else np.dtype(dtype).itemsize)
    return int(np.prod(dims, dtype=np.int64)) * itemsize


def kv_cache_bytes_per_device(mesh, cache_shapes, quantized=False) -> int:
    """Bytes one rank holds for a dense cache of leaves ``cache_shapes``
    (``(shape, dtype)`` pairs): each leaf at its engaged axes only."""
    return sum(shard_bytes(s, dt, mesh, kv_cache_layout(quantized, len(s)))
               for s, dt in cache_shapes)


def tree_bytes_per_device(tree) -> int:
    """Bytes of a rank's (sharded) parameter dict: its local tensors,
    which are the shards (a quantized leaf's parts summed)."""
    total = 0
    for leaf in tree.values():
        for t in (leaf.values() if isinstance(leaf, dict) else (leaf,)):
            total += t.numel() * t.element_size()
    return total


class ModelParallel:
    """What a rank's forward pass needs to know of the mesh: which leaves
    it holds a slice of (and so which products need a ``tp`` sum or
    gather), its local head counts, the kv heads its q heads read, and
    its place on the ``sp`` ring.  Built once per engine
    (:meth:`build`) and carried on the spec (``ModelSpec.par``)."""

    def __init__(self, spec: ModelSpec, mesh):
        ms = mesh_shape(mesh)
        self.mesh = mesh
        self.tp, self.sp, self.dp = ms["tp"], ms["sp"], ms["dp"]
        self.tp_rank = mesh.get_local_rank("tp") if self.tp > 1 else 0
        self.sp_rank = mesh.get_local_rank("sp") if self.sp > 1 else 0
        self.dp_rank = mesh.get_local_rank("dp") if self.dp > 1 else 0
        self.heads_split = leaf_dim("wq", spec, self.tp) is not None
        self.kv_split = leaf_dim("wk", spec, self.tp) is not None
        self.mlp_split = leaf_dim("w_down", spec, self.tp) is not None
        self.vocab_split = leaf_dim("embed", spec, self.tp) is not None
        self.heads, self.kv_heads = local_heads(spec, self.tp)
        self.num_kv_heads = spec.num_kv_heads
        # The kv heads this rank's q heads read: all of its local ones,
        # except where q heads split and kv heads replicate — then the
        # kv heads of global q heads [r H_loc, (r+1) H_loc), as a slice
        # when they map evenly, else one index per q head.
        self.kv_sel = None
        if self.heads_split and not self.kv_split:
            g = spec.num_heads // spec.num_kv_heads
            h0 = self.tp_rank * self.heads
            if self.heads % g == 0:
                self.kv_sel = slice(h0 // g, (h0 + self.heads) // g)
            elif g % self.heads == 0:
                self.kv_sel = slice(h0 // g, h0 // g + 1)
            else:
                self.kv_sel = torch.tensor([(h0 + i) // g for i in range(self.heads)])

    def decode_plan(self, batch: int) -> Tuple[int, int]:
        """The ``(batch, kv heads)`` a rank's decode-attention split is
        planned for: the whole mesh's (its rows times dp, the model's kv
        heads), so that its splits are one device's."""
        return batch * self.dp, self.num_kv_heads

    def select_kv(self, t: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """The kv heads (along ``dim``) this rank's q heads read."""
        if self.kv_sel is None:
            return t
        if isinstance(self.kv_sel, slice):
            return t.narrow(dim, self.kv_sel.start, self.kv_sel.stop - self.kv_sel.start)
        return t.index_select(dim, self.kv_sel.to(t.device))
