"""BAD: mesh axis names the mesh does not define."""
from bcg_tpu_torch.parallel.collectives import all_gather, all_reduce, axis_size
from bcg_tpu_torch.parallel.mesh import mesh_shape


def row_parallel(x, mesh):
    return all_reduce(x, mesh, "tpp")              # BCG-SHARD-AXIS ("tpp")


def gather_rows(x, mesh):
    return all_gather(x, mesh, axis="data")        # BCG-SHARD-AXIS ("data")


def heads(spec, mesh):
    tp = mesh_shape(mesh).get("model", 1)          # BCG-SHARD-AXIS ("model")
    dp = mesh_shape(mesh)["batch"]                 # BCG-SHARD-AXIS ("batch")
    return spec.num_heads // tp, dp, axis_size(mesh, "seq")  # BCG-SHARD-AXIS ("seq")


def my_rank(mesh):
    return mesh.get_local_rank("tensor")           # BCG-SHARD-AXIS ("tensor")
