"""GOOD: every mesh axis named is one parallel/mesh.py defines."""
from bcg_tpu_torch.parallel.collectives import all_gather, all_reduce, axis_size
from bcg_tpu_torch.parallel.mesh import mesh_shape


def row_parallel(x, mesh):
    return all_reduce(x, mesh, "tp", op="sum")


def gather_rows(x, mesh):
    return all_gather(x, mesh, axis="dp", dim=0)


def heads(spec, mesh):
    tp = mesh_shape(mesh).get("tp", 1)
    dp = mesh_shape(mesh)["dp"]
    return spec.num_heads // tp, dp, axis_size(mesh, "sp")


def my_rank(mesh, axis):
    # A name, not a literal: the rule checks literals only.
    return mesh.get_local_rank(axis), mesh.get_group("tp")
