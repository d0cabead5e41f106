"""The PyTorch port's package rules: it imports neither JAX nor anything
of the JAX package, its engine runs on CUDA unless asked for the CPU,
and every knob outside the ported path raises instead of being ignored.
"""

import json
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


# The modules of the loader and observability slice: each imported in a
# fresh interpreter that then holds neither JAX nor the JAX package.
SLICE_MODULES = [
    "bcg_tpu_torch.models.safetensors_np", "bcg_tpu_torch.models.loader",
    "bcg_tpu_torch.models.artifact", "bcg_tpu_torch.obs", "bcg_tpu_torch.obs.counters",
    "bcg_tpu_torch.obs.tracer", "bcg_tpu_torch.obs.ledger", "bcg_tpu_torch.obs.fleet",
    "bcg_tpu_torch.obs.export", "bcg_tpu_torch.obs.game_events", "bcg_tpu_torch.obs.alerts",
    "bcg_tpu_torch.obs.hostsync", "bcg_tpu_torch.obs.compile", "bcg_tpu_torch.obs.hlo",
    "bcg_tpu_torch.runtime.resilience", "bcg_tpu_torch.runtime.profiler",
]
# The modules of the serving and sweep slice, alike.
SERVE_MODULES = [
    "bcg_tpu_torch.engine.fake", "bcg_tpu_torch.engine.fault",
    "bcg_tpu_torch.engine.collective", "bcg_tpu_torch.serve", "bcg_tpu_torch.serve.scheduler",
    "bcg_tpu_torch.serve.engine", "bcg_tpu_torch.sweep", "bcg_tpu_torch.sweep.spec",
    "bcg_tpu_torch.sweep.controller", "bcg_tpu_torch.sweep.__main__",
    "bcg_tpu_torch.experiments", "bcg_tpu_torch.api", "bcg_tpu_torch.cli",
]
# The modules of the fused mega-round slice, alike.
MEGAROUND_MODULES = [
    "bcg_tpu_torch.engine.megaround", "bcg_tpu_torch.parallel",
    "bcg_tpu_torch.parallel.game_step", "bcg_tpu_torch.guided.token_dfa",
]


@pytest.fixture(scope="module")
def slice_imports():
    code = (
        "import importlib, json, subprocess, sys\n"
        f"mods = {SLICE_MODULES + SERVE_MODULES + MEGAROUND_MODULES!r}\n"
        "out = {}\n"
        "for m in mods:\n"
        "    r = subprocess.run([sys.executable, '-c', 'import importlib, sys; '\n"
        "        f'importlib.import_module({m!r}); '\n"
        "        'print(sorted(k for k in sys.modules if k.split(\".\")[0] in (\"jax\", \"bcg_tpu\")))'],\n"
        "        capture_output=True, text=True)\n"
        "    out[m] = [r.returncode, r.stdout.strip(), r.stderr[-500:]]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    import json

    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mod", SLICE_MODULES)
def test_slice_module_imports_without_jax_or_the_jax_package(slice_imports, mod):
    rc, loaded, err = slice_imports[mod]
    assert rc == 0, err
    assert loaded == "[]"


@pytest.mark.parametrize("mod", SERVE_MODULES)
def test_serve_slice_module_imports_without_jax_or_the_jax_package(slice_imports, mod):
    rc, loaded, err = slice_imports[mod]
    assert rc == 0, err
    assert loaded == "[]"


@pytest.mark.parametrize("mod", MEGAROUND_MODULES)
def test_megaround_slice_module_imports_without_jax_or_the_jax_package(slice_imports, mod):
    rc, loaded, err = slice_imports[mod]
    assert rc == 0, err
    assert loaded == "[]"


# The static checker and the HF fixture / tokenizer slice: each imported
# in a fresh interpreter that then holds neither JAX, the JAX package,
# transformers nor tokenizers.
CHECKER_HF_MODULES = [
    "bcg_tpu_torch.analysis", "bcg_tpu_torch.analysis.core", "bcg_tpu_torch.analysis.rules",
    "bcg_tpu_torch.analysis.interproc", "bcg_tpu_torch.analysis.__main__",
    "bcg_tpu_torch.models.hf_fixture", "bcg_tpu_torch.engine.tokenizer",
    "bcg_tpu_torch.engine.tokenizer_json",
]


@pytest.fixture(scope="module")
def checker_hf_imports():
    code = (
        "import json, subprocess, sys\n"
        f"mods = {CHECKER_HF_MODULES!r}\n"
        "out = {}\n"
        "for m in mods:\n"
        "    r = subprocess.run([sys.executable, '-c', 'import importlib, sys; '\n"
        "        f'importlib.import_module({m!r}); '\n"
        "        'print(sorted(k for k in sys.modules if k.split(\".\")[0] in '\n"
        "        '(\"jax\", \"bcg_tpu\", \"transformers\", \"tokenizers\")))'],\n"
        "        capture_output=True, text=True)\n"
        "    out[m] = [r.returncode, r.stdout.strip(), r.stderr[-500:]]\n"
        "print(json.dumps(out))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mod", CHECKER_HF_MODULES)
def test_checker_and_hf_module_imports_without_jax_transformers_or_tokenizers(
        checker_hf_imports, mod):
    rc, loaded, err = checker_hf_imports[mod]
    assert rc == 0, err
    assert loaded == "[]"


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
    # Every knob the port serves on one device is served over a mesh too
    # (A13a, A13b items 1-5): without a world of the mesh's size it says so.
    (dict(paged_kv=True, quantization="int8", tensor_parallel_size=2), None),
    (dict(quantization="int8", data_parallel_size=2), None),
    (dict(quantization="int4", sequence_parallel_size=2), None),
    (dict(kv_cache_dtype="int4", quantization="int4", tensor_parallel_size=2), None),
    (dict(paged_kv=True, tensor_parallel_size=2), None),
    (dict(kv_cache_dtype="int4", paged_kv=True, data_parallel_size=2), None),
    (dict(tensor_parallel_size=2), None),
    (dict(data_parallel_size=2), None),
    (dict(sequence_parallel_size=2), None),
    # The JAX engine's two refusals under sp, in its words.
    (dict(kv_cache_dtype="int4", sequence_parallel_size=2),
     "kv_cache_dtype='int4' does not compose with sequence parallelism"),
    (dict(paged_kv=True, sequence_parallel_size=2),
     "paged_kv does not compose with sequence parallelism"),
])
def test_unported_knobs_raise(knob, item):
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test", **knob)
    with pytest.raises(ValueError, match=item or "needs a world of 2 ranks, have 1"):
        TorchEngine(cfg, device="cpu")


@pytest.mark.parametrize("knob", [
    dict(decode_fast_forward=True),
    dict(spec_decode=True),
    dict(kv_cache_dtype="int8"),
    dict(kv_cache_dtype="int8", decode_fast_forward=True),
    dict(kv_cache_dtype="int8", spec_decode=True),
    dict(decode_fast_forward=True, spec_decode=True),
    dict(paged_kv=True),
    dict(paged_kv=True, kv_cache_dtype="int4", decode_fast_forward=True),
    dict(paged_kv=True, kv_cache_dtype="int8", spec_decode=True),
    dict(quantization="int8", kv_cache_dtype="int8", decode_fast_forward=True),
    dict(quantization="int4"),
    dict(quantization="int4", paged_kv=True, kv_cache_dtype="int4", spec_decode=True),
])
def test_ported_decode_paths_are_accepted(knob):
    """The fast-forward and speculative loops, the int8 dense cache, the
    paged pools and the quantized weights, alone and combined
    (speculative decoding wins over fast-forward)."""
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test", **knob)
    eng = TorchEngine(cfg, device="cpu")
    assert eng.quantization == knob.get("quantization")
    assert eng.kv_int8 == (knob.get("kv_cache_dtype") == "int8")
    assert eng.spec_decode == knob.get("spec_decode", False)
    assert eng.fast_forward == knob.get("decode_fast_forward", False)
    assert (eng._paged is not None) == knob.get("paged_kv", False)


def test_int4_kv_cache_is_accepted_and_warns_without_paging():
    cfg = EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test", kv_cache_dtype="int4")
    with pytest.warns(UserWarning, match="without paged_kv"):
        eng = TorchEngine(cfg, device="cpu")
    assert eng.kv_quantized == "int4" and eng._paged is None


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
    monkeypatch.setenv("BCG_TPU_KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("BCG_TPU_KV_POOL_BLOCKS", "100")
    eng = TorchEngine(cfg, device="cpu")
    assert eng._paged.block_size == 8 and eng._paged.num_blocks == 100
    monkeypatch.setenv("BCG_TPU_PAGED_KV_IMPL", "gather")
    with pytest.raises(ValueError, match="paged_kv_impl"):
        TorchEngine(cfg, device="cpu")
    for name in ("BCG_TPU_PAGED_KV", "BCG_TPU_KV_BLOCK_SIZE", "BCG_TPU_KV_POOL_BLOCKS",
                 "BCG_TPU_PAGED_KV_IMPL"):
        monkeypatch.delenv(name)
    monkeypatch.setenv("BCG_TPU_KV_DTYPE", "int4")
    with pytest.warns(UserWarning, match="int4"):
        assert TorchEngine(cfg, device="cpu").kv_quantized == "int4"
    monkeypatch.setenv("BCG_TPU_KV_DTYPE", "int8")
    assert TorchEngine(cfg, device="cpu").kv_int8
    monkeypatch.setenv("BCG_TPU_SPEC", "1")
    assert TorchEngine(cfg, device="cpu").spec_decode


@pytest.mark.parametrize("topology", ["fully_connected", "ring"])
def test_orchestrator_rejects_unported_round_paths(topology):
    """The SPMD exchange is ported (A13a): over an engine with no mesh it
    is the one-device exchange, and the game equals the host exchange's
    (as ``tests/test_parallel.py::TestSPMDExchangeIntegration`` holds the
    JAX package's); it still refuses a lossy channel it would bypass."""
    from bcg_tpu_torch.config import (BCGConfig, CommunicationConfig, EngineConfig, GameConfig,
                                      MetricsConfig, NetworkConfig)
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    base = BCGConfig(metrics=MetricsConfig(save_results=False))
    with pytest.raises(ValueError, match="spmd_exchange bypasses the host protocol"):
        BCGSimulation(base.replace(network=NetworkConfig(spmd_exchange=True),
                                   communication=CommunicationConfig(protocol_type="lossy_sim")),
                      engine=object())

    def play(spmd):
        cfg = base.replace(
            game=GameConfig(num_honest=6, num_byzantine=2, max_rounds=6, seed=3),
            network=NetworkConfig(topology_type=topology, spmd_exchange=spmd),
            engine=EngineConfig(backend="fake"))
        sim = BCGSimulation(config=cfg)
        try:
            while not sim.game.game_over:
                sim.run_round()
            return (sim.game.get_statistics(),
                    sim.network.protocol.get_total_message_count() + sim._spmd_message_count)
        finally:
            sim.close()

    assert play(True) == play(False)


def test_create_engine_serves_torch_only():
    from bcg_tpu_torch.engine import create_engine
    from bcg_tpu_torch.engine.fault import FaultInjectingEngine

    with pytest.raises(ValueError, match="torch"):
        create_engine(EngineConfig(backend="jax", model_name="bcg-tpu/tiny-test"), device="cpu")
    eng = create_engine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test",
                                     fault_rate=0.1), device="cpu")
    assert isinstance(eng, FaultInjectingEngine) and eng.rate == 0.1
    assert isinstance(eng._engine, TorchEngine) and eng._engine.device.type == "cpu"
    eng = create_engine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test"),
                        device="cpu")
    assert isinstance(eng, TorchEngine) and eng.device.type == "cpu"
    assert EngineConfig().backend == "torch"


def test_kernel_sources_ship_with_the_package():
    csrc = os.path.join(PKG, "csrc")
    for name in ("flash_prefill", "decode_attention", "guided_sampler",
                 "chunk_decode_attention", "decode_attention_int8", "paged_attention",
                 "w4a16"):
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


@pytest.mark.parametrize("flag,field", [
    # The mesh flags and the SPMD exchange are ported (A13a): they reach
    # the config; scan-over-layers has no counterpart in the port.
    ("--tensor-parallel=2", ("engine", "tensor_parallel_size", 2)),
    ("--sequence-parallel=2", ("engine", "sequence_parallel_size", 2)),
    ("--data-parallel=2", ("engine", "data_parallel_size", 2)),
    ("--scan-layers", None),
    ("--spmd-exchange", ("network", "spmd_exchange", True)),
])
def test_cli_offers_no_flag_of_an_unported_path(flag, field, capsys):
    from bcg_tpu_torch.cli import build_parser, config_from_args

    if field is None:
        with pytest.raises(SystemExit):
            build_parser().parse_args([flag])
        assert "unrecognized arguments" in capsys.readouterr().err
        return
    cfg = config_from_args(build_parser().parse_args([flag]))
    section, name, value = field
    assert getattr(getattr(cfg, section), name) == value


def _serves(capsys):
    from bcg_tpu_torch.cli import main

    assert main(["--backend", "fake", "--honest", "3", "--byzantine", "0", "--rounds", "1",
                 "--no-save", "--serve", "--verbose"]) == 0
    out = capsys.readouterr().out
    stats = json.loads(out[out.index("[Serving Scheduler]") + len("[Serving Scheduler]"):])
    return stats["completed"] > 0 and stats["failed"] == 0


# The serving slice's flags: each reaches the config or the serving wrapper.
@pytest.mark.parametrize("flag, reached", [
    ("--serve", lambda cfg, capsys: _serves(capsys)),
    ("--fake-policy=stubborn", lambda cfg, capsys: cfg.engine.fake_policy == "stubborn"),
    ("--fault-rate=0.1", lambda cfg, capsys: cfg.engine.fault_rate == 0.1),
    ("--fault-seed=1", lambda cfg, capsys: cfg.engine.fault_seed == 1),
    ("--backend=torch", lambda cfg, capsys: cfg.engine.backend == "torch"),
])
def test_cli_flag_of_the_serving_slice_reaches_the_run(flag, reached, capsys):
    from bcg_tpu_torch.cli import build_parser, config_from_args

    cfg = config_from_args(build_parser().parse_args([flag]))
    assert reached(cfg, capsys)


def test_cli_serves_the_decode_loops_and_the_int8_cache(capsys):
    from bcg_tpu_torch.cli import build_parser, config_from_args

    args = build_parser().parse_args(["--model", "tiny-test", "--device", "cpu",
                                      "--fast-forward", "--kv-cache-dtype", "int8"])
    cfg = config_from_args(args)
    assert cfg.engine.decode_fast_forward and cfg.engine.kv_cache_dtype == "int8"
    assert not cfg.engine.spec_decode
    cfg = config_from_args(build_parser().parse_args(["--spec-decode"]))
    assert cfg.engine.spec_decode and cfg.engine.kv_cache_dtype == "bfloat16"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--kv-cache-dtype", "int4"])
    assert "invalid choice" in capsys.readouterr().err


def test_paged_slice_modules_import_without_jax_and_count():
    """The modules of the paged slice (the int4 KV quantizer, the paged
    pool and attention, the radix manager) are among those the import
    test walks and the source scan reads; the paged wrappers carry a
    launch count per pool layout and the plain versions a call count."""
    from bcg_tpu_torch.ops import _build, paged_attention as pa

    mods = _modules()
    for m in ("bcg_tpu_torch.models.quantize", "bcg_tpu_torch.ops.paged_attention",
              "bcg_tpu_torch.engine.paged_kv"):
        assert m in mods
    assert "paged_attention" in _build.SOURCES
    for fn in (pa.paged_decode_attention, pa.paged_chunk_attention):
        assert set(fn.launches) == {"bf16", "int8", "int4"}
    for fn in (pa.paged_decode_attention_plain, pa.paged_chunk_attention_plain):
        assert isinstance(fn.calls, int)


def test_new_kernel_forms_live_in_modules_that_import_without_jax():
    """The modules this slice extended (chunk and int8 decode attention,
    the drafter and spec loop, forced chains, the chunk model entry
    points) are among those the import test walks, and carry their
    launch counts."""
    from bcg_tpu_torch.ops import decode_attention as da

    mods = _modules()
    for m in ("bcg_tpu_torch.ops.decode_attention", "bcg_tpu_torch.engine.speculative",
              "bcg_tpu_torch.guided.processor", "bcg_tpu_torch.models.transformer"):
        assert m in mods
    for fn in (da.decode_attention, da.chunk_decode_attention, da.decode_attention_int8,
               da.chunk_decode_attention_int8):
        assert isinstance(fn.launches, int)


def test_weight_quantization_modules_import_without_jax_and_count():
    """The modules of the weight-quantization slice (the quantizers and
    ``dense``, the W4A16 kernel's wrapper) are among those the import test
    walks and the source scan reads; the wrapper carries a launch count
    and its source is in the build list."""
    from bcg_tpu_torch.models import quantize
    from bcg_tpu_torch.ops import _build, w4_matmul

    mods = _modules()
    for m in ("bcg_tpu_torch.models.quantize", "bcg_tpu_torch.ops.w4_matmul",
              "bcg_tpu_torch.models.convert", "bcg_tpu_torch.cli"):
        assert m in mods
    assert "w4a16" in _build.SOURCES
    assert isinstance(w4_matmul.w4a16_matmul.launches, int)
    for name in ("quantize_weight", "quantize_weight_int4", "unpack_int4", "dequantize_int4",
                 "dense", "quantize_params", "quantize_leaf_transform",
                 "ensure_quantized_head", "int4_group_for"):
        assert callable(getattr(quantize, name))
