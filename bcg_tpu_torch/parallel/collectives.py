"""The collectives each mesh dimension needs, over that dimension's process
group — what XLA inserts from sharding annotations in the JAX package.

* :func:`all_reduce` (sum or max; an int32 sum is exact, which the
  W8A8 row-parallel product needs), :func:`all_gather` along a tensor
  dimension, :func:`broadcast` from a group-local rank and
  :func:`ring_shift` (every rank sends to its successor on the axis and
  receives from its predecessor: the ring attention's neighbour exchange,
  ``batch_isend_irecv``).
* :func:`broadcast_object`: a picklable object of one rank on every rank
  of the world (the serving tier's dispatches, led from rank 0).
* A size-1 axis (or no mesh) returns its input untouched and launches
  nothing.
* Where an axis's group is gloo and a tensor lies on CUDA (ranks sharing
  one card), the collective goes through pinned host memory: chosen from
  the backend and the device, never by catching an error.  The torch
  documentation's backend table lists CUDA ``all_reduce`` and
  ``broadcast`` for gloo, but torch 2.11's gloo on the H100 machine
  aborts the process on a CUDA ``all_reduce`` (``writev ... Bad
  address``), so every kind is staged.  Each collective counts
  ``engine.collective.<kind>`` and each staged one
  ``engine.collective.staged`` (``obs/counters``; under the registered
  ``engine`` subsystem, since the metric taxonomy the port shares with
  the JAX package has no ``parallel`` one).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.parallel.mesh import mesh_shape


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh).get(axis, 1)


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return mesh.get_local_rank(axis) if axis_size(mesh, axis) > 1 else 0


def _staged(kind: str, t: torch.Tensor, group) -> bool:
    staged = t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO
    obs_counters.inc(f"engine.collective.{kind}")
    if staged:
        obs_counters.inc("engine.collective.staged")
    return staged


def _to_host(t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def all_reduce(t: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """Sum or max of ``t`` over ``axis``, in place; returns ``t``."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if _staged("all_reduce", t, group):
        host = _to_host(t)
        dist.all_reduce(host, op=red, group=group)
        return t.copy_(host)
    dist.all_reduce(t, op=red, group=group)
    return t


def broadcast(t: torch.Tensor, mesh, axis: str, src: int = 0) -> torch.Tensor:
    """``t`` of the rank at coordinate ``src`` along ``axis``, in place."""
    if axis_size(mesh, axis) == 1:
        return t
    group = mesh.get_group(axis)
    src_global = dist.get_global_rank(group, src)
    if _staged("broadcast", t, group):
        host = _to_host(t)
        dist.broadcast(host, src=src_global, group=group)
        return t.copy_(host)
    dist.broadcast(t, src=src_global, group=group)
    return t


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (all of one shape) concatenated along ``dim`` in
    axis order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    group = mesh.get_group(axis)
    src = t.contiguous()
    if _staged("all_gather", t, group):
        host = _to_host(src)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return torch.cat(parts, dim=dim).to(t.device)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def ring_shift(tensors: Sequence[torch.Tensor], mesh, axis: str) -> List[torch.Tensor]:
    """Send each tensor to the next rank along ``axis`` and return the
    ones the previous rank sent (one ``batch_isend_irecv``)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return list(tensors)
    group = mesh.get_group(axis)
    me = axis_rank(mesh, axis)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    staged = _staged("ring_shift", tensors[0], group)
    srcs = [_to_host(t) if staged else t.contiguous() for t in tensors]
    outs = [torch.empty_like(s) for s in srcs]
    ops = ([dist.P2POp(dist.isend, s, nxt, group) for s in srcs]
           + [dist.P2POp(dist.irecv, o, prv, group) for o in outs])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [o.to(t.device) for o, t in zip(outs, tensors)] if staged else outs


def broadcast_object(obj, src: int = 0):
    """``obj`` of global rank ``src`` on every rank of the world (pickled,
    over the world's default group, whose object collectives go through
    host memory on gloo); ``obj`` is ignored on the other ranks.  Without
    a world, ``obj`` itself."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    obs_counters.inc("engine.collective.broadcast_object")
    box = [obj if dist.get_rank() == src else None]
    dist.broadcast_object_list(box, src=src)
    return box[0]
