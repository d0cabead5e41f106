"""Checkpoint loading in the PyTorch port against the JAX package.

* The port's numpy safetensors reader and writer against the
  ``safetensors`` package, both ways, for every dtype the loaders read
  (and an empty tensor, and ``__metadata__``): the same tensors, and the
  same file bytes.
* The ``bcg-hf/tiny`` fixture (a real HF layout: safetensors shards, a
  ``tokenizers`` tokenizer, ``config.json``; built on disk by the JAX
  package's ``hf_fixture``): both packages' ``find_checkpoint_dir`` find
  the same directory, and the port's ``load_checkpoint_params`` equals
  the JAX loader leaf for leaf in bf16 bits, and in the int8 and int4
  parts once the port's output-major layout is read back row-major.
* Pre-quantized artifacts: saved by either package, loaded by the other,
  bit for bit; every manifest mismatch raises ``ValueError``.
* The engine: ``JaxEngine`` and ``TorchEngine(device="cpu")`` booted from
  the NAME ``bcg-hf/tiny`` through discovery (tokenizer included) give
  token-identical greedy decision and vote rows; a name without a
  checkpoint raises ``FileNotFoundError``.
"""

import json
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as st_save

from bcg_tpu.models import artifact as j_artifact
from bcg_tpu.models import loader as j_loader
from bcg_tpu.models import quantize as j_quantize
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.models.hf_fixture import build_checkpoint
from bcg_tpu_torch.models import artifact, loader, quantize, safetensors_np
from bcg_tpu_torch.models.configs import spec_for_model
import _torch_jax_obs_state

TINY = "bcg-hf/tiny"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


# ------------------------------------------------------------ safetensors

def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "bf16": rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16),
        "f16": rng.standard_normal((4,)).astype(np.float16),
        "f32": rng.standard_normal((2, 3, 2)).astype(np.float32),
        "i8": rng.integers(-128, 128, (6, 2), dtype=np.int8),
        "u8": rng.integers(0, 256, (7,), dtype=np.uint8),
        "u16": rng.integers(0, 1 << 16, (3,), dtype=np.uint16),
        "i32": rng.integers(-9, 9, (2, 2), dtype=np.int32),
        "i64": rng.integers(-9, 9, (3,), dtype=np.int64),
        "empty": np.zeros((0, 4), np.float32),
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8) if a.size else a.reshape(-1).view(np.uint8)


@pytest.mark.parametrize("name", list(_arrays()))
def test_safetensors_reads_what_the_library_writes(tmp_path, name):
    arrs = _arrays()
    path = str(tmp_path / "lib.safetensors")
    st_save(arrs, path, metadata={"format": "np", "note": "x"})
    with safetensors_np.SafetensorsFile(path) as f:
        assert f.metadata() == {"format": "np", "note": "x"}
        assert sorted(f.keys()) == sorted(arrs)
        got = f.numpy(name)
        assert got.shape == arrs[name].shape
        assert np.array_equal(_bits(got), _bits(arrs[name]))
        t = f.tensor(name)
        assert tuple(t.shape) == arrs[name].shape
        if name == "bf16":
            assert t.dtype == torch.bfloat16
            assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                                  arrs[name].view(np.uint16))
        elif arrs[name].size:
            assert np.array_equal(t.numpy(), arrs[name])


@pytest.mark.parametrize("name", list(_arrays()))
def test_the_library_reads_what_safetensors_np_writes(tmp_path, name):
    arrs = _arrays(1)
    path = str(tmp_path / "port.safetensors")
    safetensors_np.save_file(arrs, path, metadata={"k": "v"})
    with safe_open(path, framework="numpy") as f:
        assert f.metadata() == {"k": "v"}
        got = f.get_tensor(name)
    assert got.dtype == arrs[name].dtype and got.shape == arrs[name].shape
    assert np.array_equal(_bits(got), _bits(arrs[name]))


@pytest.mark.parametrize("metadata", [None, {"format": "pt"}])
def test_safetensors_np_writes_the_library_bytes(tmp_path, metadata):
    """From numpy arrays and from torch tensors alike."""
    arrs = _arrays(2)
    st_save(arrs, str(tmp_path / "a"), metadata=metadata)
    safetensors_np.save_file(arrs, str(tmp_path / "b"), metadata=metadata)
    tensors = {k: (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16) if k == "bf16"
                   else torch.from_numpy(np.asarray(v))) for k, v in arrs.items()}
    safetensors_np.save_file(tensors, str(tmp_path / "c"), metadata=metadata)
    ref = (tmp_path / "a").read_bytes()
    assert (tmp_path / "b").read_bytes() == ref
    assert (tmp_path / "c").read_bytes() == ref


def test_safetensors_np_refuses_a_truncated_file(tmp_path):
    path = tmp_path / "t.safetensors"
    safetensors_np.save_file({"x": np.ones((64,), np.float32)}, str(path))
    path.write_bytes(path.read_bytes()[:-8])
    with pytest.raises(ValueError, match="offsets"):
        safetensors_np.SafetensorsFile(str(path))


# ------------------------------------------------------------ checkpoints

@pytest.fixture(scope="module")
def hf_checkpoint(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_ckpt")
    return build_checkpoint(TINY, out_dir=str(root / "bcg-hf--tiny"))


@pytest.fixture()
def hf_env(hf_checkpoint, monkeypatch):
    monkeypatch.setenv("BCG_TPU_CHECKPOINT_DIR", os.path.dirname(hf_checkpoint))
    return hf_checkpoint


def test_find_checkpoint_dir_matches_the_jax_package(hf_env, tmp_path, monkeypatch):
    assert loader.find_checkpoint_dir(TINY) == j_loader.find_checkpoint_dir(TINY)
    assert os.path.samefile(loader.find_checkpoint_dir(TINY), hf_env)
    # A path as the name, and a name with no checkpoint anywhere.
    assert loader.find_checkpoint_dir(hf_env) == j_loader.find_checkpoint_dir(hf_env)
    monkeypatch.setenv("BCG_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    assert loader.find_checkpoint_dir(TINY) is None
    assert j_loader.find_checkpoint_dir(TINY) is None
    with pytest.raises(FileNotFoundError, match="BCG_TPU_CHECKPOINT_DIR"):
        loader.load_checkpoint_params(spec_for_model(TINY), TINY, "cpu")


def test_find_checkpoint_dir_walks_hf_home_snapshots(hf_checkpoint, tmp_path, monkeypatch):
    snap = tmp_path / "hub" / "models--bcg-hf--tiny" / "snapshots" / "abc123"
    snap.mkdir(parents=True)
    for f in os.listdir(hf_checkpoint):
        if f.endswith(".safetensors"):
            os.symlink(os.path.join(hf_checkpoint, f), snap / f)
    monkeypatch.delenv("BCG_TPU_CHECKPOINT_DIR", raising=False)
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    assert loader.find_checkpoint_dir(TINY) == str(snap)
    assert j_loader.find_checkpoint_dir(TINY) == str(snap)


def _j_leaves(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, layer in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    return out


def _t_bits(t):
    t = t.contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _j_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


@pytest.fixture(scope="module")
def j_params(hf_checkpoint):
    return _j_leaves(j_loader.load_checkpoint_params(j_spec(TINY), TINY, ckpt_dir=hf_checkpoint))


def test_loader_equals_the_jax_loader_in_bf16_bits(hf_env, j_params):
    spec = spec_for_model(TINY)
    params = loader.load_checkpoint_params(spec, TINY, "cpu")
    assert sorted(params) == sorted(j_params)
    for name, t in params.items():
        assert t.dtype == torch.bfloat16 and t.is_contiguous(), name
        assert np.array_equal(_t_bits(t), _j_bits(j_params[name])), name
    # The leaves init_params makes: the plan's names and shapes.
    from bcg_tpu_torch.models.transformer import param_plan

    assert [n for n, _, _ in param_plan(spec)] == list(params)
    assert all(tuple(params[n].shape) == tuple(s) for n, _, s in param_plan(spec))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_streamed_quantized_load_equals_the_jax_package(hf_checkpoint, mode):
    spec = spec_for_model(TINY)
    params = loader.load_checkpoint_params(
        spec, TINY, "cpu", leaf_transform=quantize.quantize_leaf_transform(spec, mode),
        ckpt_dir=hf_checkpoint)
    jp = _j_leaves(j_loader.load_checkpoint_params(
        j_spec(TINY), TINY, ckpt_dir=hf_checkpoint,
        leaf_transform=j_quantize.quantize_leaf_transform(j_spec(TINY), mode)))
    assert sorted(params) == sorted(jp)
    n_quant = 0
    for name, leaf in params.items():
        if isinstance(leaf, dict):
            n_quant += 1
            assert sorted(leaf) == sorted(jp[name]), name
            for part, t in leaf.items():
                if part in ("q", "q4"):   # stored output-major, read row-major
                    assert t.stride() == (1, t.shape[0]), name
                assert np.array_equal(_t_bits(t), _j_bits(jp[name][part])), f"{name}.{part}"
        else:
            assert np.array_equal(_t_bits(leaf), _j_bits(jp[name])), name
    assert n_quant == 7 * spec.num_layers + (0 if spec.tie_embeddings else 1)


# ------------------------------------------------------------ artifacts

def _quantized_pair(hf_checkpoint, mode):
    spec = spec_for_model(TINY)
    tp = loader.load_checkpoint_params(
        spec, TINY, "cpu", leaf_transform=quantize.quantize_leaf_transform(spec, mode),
        ckpt_dir=hf_checkpoint)
    quantize.ensure_quantized_head(tp, spec, mode)
    jp = j_loader.load_checkpoint_params(
        j_spec(TINY), TINY, ckpt_dir=hf_checkpoint,
        leaf_transform=j_quantize.quantize_leaf_transform(j_spec(TINY), mode))
    j_quantize.ensure_quantized_head(jp, j_spec(TINY), mode=mode)
    return tp, jp


def _assert_same_tree(tp, jleaves):
    assert sorted(tp) == sorted(jleaves)
    for name, leaf in tp.items():
        if isinstance(leaf, dict):
            assert sorted(leaf) == sorted(jleaves[name])
            for part, t in leaf.items():
                assert np.array_equal(_t_bits(t), _j_bits(jleaves[name][part])), f"{name}.{part}"
        else:
            assert np.array_equal(_t_bits(leaf), _j_bits(jleaves[name])), name


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_artifacts_load_both_ways_bit_for_bit(hf_checkpoint, tmp_path, mode):
    spec = spec_for_model(TINY)
    tp, jp = _quantized_pair(hf_checkpoint, mode)
    j_dir, t_dir = str(tmp_path / "from_jax"), str(tmp_path / "from_torch")
    j_artifact.save_quantized_artifact(jp, j_spec(TINY), mode, j_dir)
    artifact.save_quantized_artifact(tp, spec, mode, t_dir)
    # The same files: every safetensors file byte for byte, the manifests
    # equal as JSON.
    assert sorted(os.listdir(j_dir)) == sorted(os.listdir(t_dir))
    for f in os.listdir(j_dir):
        a, b = open(os.path.join(j_dir, f), "rb").read(), open(os.path.join(t_dir, f), "rb").read()
        if f.endswith(".json"):
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, f
    assert artifact.artifact_mode(j_dir) == mode and artifact.artifact_mode(hf_checkpoint) is None
    # JAX-saved into the port, port-saved into JAX.
    loaded = artifact.load_quantized_artifact(spec, j_dir, mode, "cpu")
    _assert_same_tree(loaded, _j_leaves(jp))
    for name, leaf in loaded.items():
        for part in ("q", "q4"):
            if isinstance(leaf, dict) and part in leaf:
                assert leaf[part].stride() == (1, leaf[part].shape[0])
    back = _j_leaves(j_artifact.load_quantized_artifact(j_spec(TINY), t_dir, mode))
    _assert_same_tree(tp, back)


@pytest.fixture(scope="module")
def int8_artifact(hf_checkpoint, tmp_path_factory):
    """A bootable int8 artifact of the fixture (tokenizer and config
    beside the weights), converted by the port."""
    out = str(tmp_path_factory.mktemp("art") / "bcg-hf--tiny")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCG_TPU_CHECKPOINT_DIR", os.path.dirname(hf_checkpoint))
        artifact.convert_checkpoint(TINY, "int8", out, device="cpu")
    return out


@pytest.mark.parametrize("field,value", [
    ("mode", "int4"), ("model", "bcg-hf/other"), ("format", "v0"),
    ("num_layers", 3), ("hidden_size", 32), ("vocab_size", 256), ("num_heads", 8),
    ("num_kv_heads", 4), ("head_dim", 8), ("intermediate_size", 64),
])
def test_artifact_mismatch_raises(int8_artifact, tmp_path, field, value):
    import shutil

    bad = str(tmp_path / "bad")
    shutil.copytree(int8_artifact, bad)
    path = os.path.join(bad, artifact.MANIFEST)
    manifest = json.load(open(path))
    manifest[field] = value
    json.dump(manifest, open(path, "w"))
    with pytest.raises(ValueError):
        artifact.load_quantized_artifact(spec_for_model(TINY), bad, "int8", "cpu")


def test_artifact_mode_must_match_the_config(int8_artifact):
    with pytest.raises(ValueError, match="int8-quantized"):
        artifact.load_quantized_artifact(spec_for_model(TINY), int8_artifact, "int4", "cpu")
    with pytest.raises(ValueError, match="int8-quantized"):
        artifact.load_quantized_artifact(spec_for_model(TINY), int8_artifact, None, "cpu")


def test_convert_checkpoint_cli_writes_a_bootable_artifact(hf_env, tmp_path, capsys):
    out = str(tmp_path / "cli")
    artifact.main(["--model", TINY, "--mode", "int4", "--out", out, "--device", "cpu"])
    assert "saved int4 artifact" in capsys.readouterr().out
    assert artifact.artifact_mode(out) == "int4"
    assert "tokenizer.json" in os.listdir(out) and "config.json" in os.listdir(out)
    params = artifact.load_quantized_artifact(spec_for_model(TINY), out, "int4", "cpu")
    assert quantize.is_int4(params["layers.0.wq"])


# ------------------------------------------------------------ engines

VOTE_SCHEMA = {
    "type": "object",
    "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
    "required": ["decision"],
    "additionalProperties": False,
}
DECISION_SCHEMA = {
    "type": "object",
    "properties": {
        "internal_strategy": {"type": "string", "minLength": 1, "maxLength": 30},
        "value": {"type": "integer", "minimum": 0, "maximum": 50},
        "public_reasoning": {"type": "string", "minLength": 1, "maxLength": 30},
    },
    "required": ["internal_strategy", "value", "public_reasoning"],
    "additionalProperties": False,
}
SYSTEM = "You are agent_1 in a multi-agent consensus game."


def _rows(engine):
    prompts = [(SYSTEM, f"Your current value is {v}. Propose a value.", DECISION_SCHEMA)
               for v in (3, 17, 42)]
    prompts += [(SYSTEM, f"Round {r}: the values are close. Vote.", VOTE_SCHEMA)
                for r in (1, 2)]
    return engine.batch_generate_json(prompts, temperature=0.0, max_tokens=48)


def test_engines_boot_bcg_hf_tiny_by_name_and_agree(hf_env):
    from bcg_tpu.config import EngineConfig as JEngineConfig
    from bcg_tpu.engine.jax_engine import JaxEngine
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.tokenizer import HFTokenizer
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    je = JaxEngine(JEngineConfig(backend="jax", model_name=TINY, max_model_len=1024))
    te = TorchEngine(EngineConfig(backend="torch", model_name=TINY, max_model_len=1024),
                     device="cpu")
    assert isinstance(te.tokenizer, HFTokenizer)
    assert te.tokenizer.token_bytes() == je.tokenizer.token_bytes()
    assert all(np.array_equal(_t_bits(te.params[n]), _j_bits(v))
               for n, v in _j_leaves(je.params).items())
    assert _rows(te) == _rows(je)
    te.shutdown()


def test_engine_boots_quantized_and_from_an_artifact(hf_env, int8_artifact, monkeypatch):
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    streamed = TorchEngine(EngineConfig(backend="torch", model_name=TINY, max_model_len=1024,
                                        quantization="int8"), device="cpu")
    monkeypatch.setenv("BCG_TPU_CHECKPOINT_DIR", os.path.dirname(int8_artifact))
    booted = TorchEngine(EngineConfig(backend="torch", model_name=TINY, max_model_len=1024,
                                      quantization="int8"), device="cpu")
    assert quantize.is_quantized(booted.params["layers.1.w_down"])
    for name, leaf in streamed.params.items():
        parts = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
        for part, t in parts:
            other = booted.params[name][part] if part else booted.params[name]
            assert torch.equal(t, other), (name, part)
    assert _rows(booted) == _rows(streamed)
    with pytest.raises(ValueError, match="int8-quantized"):
        TorchEngine(EngineConfig(backend="torch", model_name=TINY, max_model_len=1024),
                    device="cpu")


def test_engine_without_a_checkpoint_raises_file_not_found(tmp_path, monkeypatch):
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.tokenizer import tokenizer_for_model
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    monkeypatch.setenv("BCG_TPU_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("HF_HOME", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="bcg-hf/tiny"):
        TorchEngine(EngineConfig(backend="torch", model_name=TINY), device="cpu")


def test_tokenizer_resolves_the_checkpoint(hf_env):
    from bcg_tpu.engine.tokenizer import tokenizer_for_model as j_tokenizer_for_model
    from bcg_tpu_torch.engine.tokenizer import tokenizer_for_model

    tok, jtok = tokenizer_for_model(TINY), j_tokenizer_for_model(TINY)
    text = '{"value": 17, "public_reasoning": "agents converge"}'
    assert tok.encode(text) == jtok.encode(text)
    assert (tok.eos_id, tok.pad_id) == (jtok.eos_id, jtok.pad_id)
