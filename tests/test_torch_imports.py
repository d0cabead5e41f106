"""The PyTorch port's package rules: it imports neither JAX nor anything
of the JAX package, its engine runs on CUDA unless asked for the CPU,
and every knob outside the ported path raises instead of being ignored.
"""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import bcg_tpu_torch
from bcg_tpu_torch.config import EngineConfig
from bcg_tpu_torch.engine.torch_engine import TorchEngine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "bcg_tpu_torch")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([PKG], prefix="bcg_tpu_torch.")
        if not m.name.endswith("__main__")
    )


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _modules()
    assert "bcg_tpu_torch.engine.torch_engine" in mods
    code = (
        "import importlib, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'bcg_tpu' or m.startswith('bcg_tpu.')]\n"
        "print('BAD', bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_source_names_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import jax|from jax\b)|\bbcg_tpu\.(?!_)", re.M)
    hits = []
    for dirpath, _, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                for i, line in enumerate(open(path, encoding="utf-8"), 1):
                    if pat.search(line):
                        hits.append(f"{os.path.relpath(path, ROOT)}:{i}: {line.strip()}")
    assert not hits, "\n".join(hits)


def test_engine_without_device_needs_cuda():
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-device rule is for CPU hosts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine(cfg, device="cuda")


@pytest.mark.parametrize("knob,item", [
    (dict(paged_kv=True), "A9"),
    (dict(decode_fast_forward=True), "A7"),
    (dict(spec_decode=True), "A7"),
    (dict(quantization="int8"), "A8"),
    (dict(quantization="int4"), "A8"),
    (dict(kv_cache_dtype="int8"), "A8"),
    (dict(kv_cache_dtype="int4"), "A8"),
    (dict(tensor_parallel_size=2), "A13"),
    (dict(data_parallel_size=2), "A13"),
    (dict(sequence_parallel_size=2), "A13"),
])
def test_unported_knobs_raise(knob, item):
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test", **knob)
    with pytest.raises(NotImplementedError, match=item):
        TorchEngine(cfg, device="cpu")


@pytest.mark.parametrize("knob", [
    dict(dtype="float32"), dict(attention_impl="xla"), dict(fused_sampler="xla"),
    dict(kv_cache_dtype="fp8"), dict(quantization="nf4"),
])
def test_invalid_or_plain_path_knobs_raise(knob):
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test", **knob)
    with pytest.raises(ValueError):
        TorchEngine(cfg, device="cpu")


def test_env_overrides_are_not_ignored(monkeypatch):
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test")
    monkeypatch.setenv("BCG_TPU_PAGED_KV", "1")
    with pytest.raises(NotImplementedError, match="A9"):
        TorchEngine(cfg, device="cpu")
    monkeypatch.delenv("BCG_TPU_PAGED_KV")
    monkeypatch.setenv("BCG_TPU_KV_DTYPE", "int8")
    with pytest.raises(NotImplementedError, match="A8"):
        TorchEngine(cfg, device="cpu")


def test_orchestrator_rejects_unported_round_paths():
    from bcg_tpu_torch.config import AgentConfig, BCGConfig, MetricsConfig, NetworkConfig
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    base = BCGConfig(metrics=MetricsConfig(save_results=False))
    with pytest.raises(NotImplementedError, match="A13"):
        BCGSimulation(base.replace(network=NetworkConfig(spmd_exchange=True)), engine=object())
    with pytest.raises(NotImplementedError, match="A10"):
        BCGSimulation(base.replace(agent=AgentConfig(megaround=True)), engine=object())


def test_create_engine_serves_torch_only():
    from bcg_tpu_torch.engine import create_engine

    with pytest.raises(ValueError, match="torch"):
        create_engine(EngineConfig(backend="jax", model_name="bcg-tpu/tiny-test"), device="cpu")
    with pytest.raises(NotImplementedError, match="A11"):
        create_engine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test",
                                   fault_rate=0.1), device="cpu")
    eng = create_engine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test"),
                        device="cpu")
    assert isinstance(eng, TorchEngine) and eng.device.type == "cpu"


def test_kernel_sources_ship_with_the_package():
    csrc = os.path.join(PKG, "csrc")
    for name in ("flash_prefill", "decode_attention", "guided_sampler"):
        text = open(os.path.join(csrc, f"{name}.cu")).read()
        assert "Replaces: bcg_tpu/ops/" in text
        assert "What bounds it on this card" in text
        assert 'extern "C" int bcg_' in text
    assert bcg_tpu_torch.__doc__


def test_cli_builds_a_torch_config_on_cuda_by_default():
    from bcg_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args(["--honest", "2", "--byzantine", "1",
                                      "--model", "tiny-test", "--no-prefix-caching"])
    cfg = config_from_args(args)
    assert args.device == "cuda"
    assert cfg.engine.backend == "torch"
    assert cfg.engine.model_name == "bcg-tpu/tiny-test"
    assert not cfg.engine.prefix_caching
    assert (cfg.game.num_honest, cfg.game.num_byzantine) == (2, 1)


@pytest.mark.parametrize("flag", [
    "--tensor-parallel=2", "--sequence-parallel=2", "--data-parallel=2",
    "--quantization=int8", "--kv-cache-dtype=int8", "--scan-layers",
    "--fast-forward", "--spec-decode", "--spmd-exchange",
    "--fake-policy=consensus", "--fault-rate=0.1", "--fault-seed=1", "--backend=torch",
])
def test_cli_offers_no_flag_of_an_unported_path(flag, capsys):
    from bcg_tpu_torch.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args([flag])
    assert "unrecognized arguments" in capsys.readouterr().err
