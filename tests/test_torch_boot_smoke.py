"""The port's abstract boot smoke (``bcg_tpu_torch/tools/boot_smoke.py``):
every preset (14B and 32B included) boots under the port's meshes with no
weight made, the smoke catches a leaf that does not place, and each
combination's final per-device tree bytes and KV bytes are the JAX
package's (``boot_peak_report`` / ``kv_cache_bytes_per_device``) for the
same preset, mesh shape and quantization — but one difference by design:
under tp an int4 row-parallel weight's group scales (``wo``, ``w_down``)
are sliced with its rows in the port and replicated in the JAX package.
The boot peak itself differs by design (the port draws each full leaf and
then slices it) and is held to the port's own contract by the smoke."""

import jax
import pytest

from bcg_tpu_torch.models.configs import MODEL_SPECS
from bcg_tpu_torch.tools import boot_smoke

PRESETS = sorted(MODEL_SPECS)


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_abstract_boots(name):
    problems = []
    for preset, _mesh_name, mesh, quant in boot_smoke.combinations():
        if preset == name:
            problems += boot_smoke.check_preset(name, mesh, quant)
    assert problems == []


def test_smoke_catches_a_leaf_that_does_not_place():
    # 151936 % 5 != 0: the vocabulary leaves would stay whole on every rank.
    problems = boot_smoke.check_preset("bcg-tpu/bench-14b", boot_smoke.ShapeMesh(tp=5), "int8")
    assert any("does not place" in p and "embed" in p for p in problems), problems


def test_run_all_prints_a_status_line_per_combination(capsys, monkeypatch):
    tiny = [c for c in boot_smoke.combinations() if c[0] == "bcg-tpu/tiny-test"]
    monkeypatch.setattr(boot_smoke, "combinations", lambda meshes=boot_smoke.MESHES: iter(tiny))
    assert boot_smoke.main() == 0
    out = capsys.readouterr().out
    assert out.count("boot_smoke: bcg-tpu/tiny-test") == len(tiny) == 8
    assert "all presets abstract-boot cleanly" in out


def _row_parallel_gscale_bytes(spec, tp):
    """Bytes of the int4 group scales of ``wo`` and ``w_down`` that a rank
    of the JAX package holds beyond the port's rank under ``tp``."""
    from bcg_tpu_torch.models.quantize import int4_group_for

    per_layer = 0
    for d_in in (spec.num_heads * spec.head_dim, spec.intermediate_size):
        per_layer += d_in // int4_group_for(d_in) * spec.hidden_size * 2
    return spec.num_layers * per_layer * (tp - 1) // tp


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("name", PRESETS)
def test_final_tree_and_kv_bytes_equal_the_jax_packages(name):
    from bcg_tpu.models.configs import MODEL_SPECS as J_SPECS
    from bcg_tpu.models.loader import boot_peak_report as j_report
    from bcg_tpu.models.transformer import init_kv_cache as j_kv
    from bcg_tpu.parallel.mesh import build_mesh
    from bcg_tpu.parallel.sharding import kv_cache_bytes_per_device as j_kv_bytes
    from bcg_tpu_torch.models.loader import boot_peak_report
    from bcg_tpu_torch.models.transformer import init_kv_cache
    from bcg_tpu_torch.parallel.mesh import mesh_shape
    from bcg_tpu_torch.parallel.sharding import kv_cache_bytes_per_device

    j_meshes = {"single": None, "tp8": build_mesh(tp=8), "dp8": build_mesh(dp=8),
                "dp2tp2sp2": build_mesh(dp=2, tp=2, sp=2)}
    spec = MODEL_SPECS[name]
    for preset, mesh_name, mesh, quant in boot_smoke.combinations():
        if preset != name:
            continue
        want = j_report(J_SPECS[name], mesh=j_meshes[mesh_name],
                        quantization=quant)["final_bytes_per_device"]
        tp = mesh_shape(mesh)["tp"]
        if quant == "int4" and tp > 1:
            want -= _row_parallel_gscale_bytes(spec, tp)
        got = boot_peak_report(spec, mesh, quant)["final_bytes_per_device"]
        assert got == want, (mesh_name, quant)
        if mesh is None:
            continue
        for B, S, kv_quant in boot_smoke.KV_CASES:
            shapes = jax.eval_shape(lambda: j_kv(J_SPECS[name], B, S, quantized=bool(kv_quant)))
            cache = init_kv_cache(spec, B, S, device="meta", quantized=kv_quant)
            leaves = [(tuple(t.shape), t.dtype) for entry in cache for t in entry.values()]
            assert (kv_cache_bytes_per_device(mesh, leaves, quantized=kv_quant)
                    == j_kv_bytes(j_meshes[mesh_name], shapes, quantized=bool(kv_quant))), (
                mesh_name, B, S, kv_quant)
