"""The port's hermetic HF fixture (``bcg_tpu_torch.models.hf_fixture``)
against the JAX package's (``bcg_tpu.models.hf_fixture``).

* The tokenizer sets the port ships (``models/fixture_tokenizers/``) are
  byte for byte what the JAX fixture trains at the tiny fixtures'
  vocabulary, so the shipped and the trained branch of
  ``build_tokenizer_files`` give the same files; another size trains, and
  without ``tokenizers`` it raises an ``ImportError`` naming it.
* ``build_checkpoint`` writes the JAX fixture's files: the same names,
  shard assignment, index, ``config.json`` and tokenizer files, every
  tensor bit-equal (the port writes through ``safetensors_np``).
* A greedy ``bcg-hf/tiny`` game on that checkpoint — the port's reader
  serving its tokenizer, each package's loader reading its weights in
  f32 — is identical under ``TorchEngine`` and ``JaxEngine``: decisions,
  votes and the whole statistics payload.
* ``python -m bcg_tpu_torch.experiments`` builds a missing ``bcg-hf/*``
  fixture on demand.
"""

import filecmp
import json
import os
import sys

import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.models import hf_fixture as j_fixture
from bcg_tpu_torch.models import hf_fixture, safetensors_np
import _torch_jax_obs_state

FAMILIES = ("chatml", "llama3", "sentencepiece")
TINY_FIXTURES = ("bcg-hf/tiny", "bcg-hf/tiny-llama3", "bcg-hf/tiny-mistral")


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


def _same_files(a, b, names):
    for name in names:
        assert filecmp.cmp(os.path.join(a, name), os.path.join(b, name), shallow=False), name


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_set_is_what_the_jax_fixture_trains(tmp_path, family):
    j_fixture.build_tokenizer_files(str(tmp_path), hf_fixture.SHIPPED_VOCAB, family)
    shipped = hf_fixture.shipped_tokenizer_dir(family, hf_fixture.SHIPPED_VOCAB)
    assert shipped is not None
    _same_files(shipped, str(tmp_path), hf_fixture.TOKENIZER_FILES)


@pytest.mark.parametrize("family", FAMILIES)
def test_shipped_branch_needs_no_tokenizers(tmp_path, monkeypatch, family):
    monkeypatch.setitem(sys.modules, "tokenizers", None)
    hf_fixture.build_tokenizer_files(str(tmp_path / "s"), hf_fixture.SHIPPED_VOCAB, family)
    _same_files(hf_fixture.shipped_tokenizer_dir(family, hf_fixture.SHIPPED_VOCAB),
                str(tmp_path / "s"), hf_fixture.TOKENIZER_FILES)
    with pytest.raises(ImportError, match="tokenizers"):
        hf_fixture.build_tokenizer_files(str(tmp_path / "t"), 320, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_trained_branch_equals_the_jax_fixture(tmp_path, family):
    assert hf_fixture.shipped_tokenizer_dir(family, 320) is None
    hf_fixture.build_tokenizer_files(str(tmp_path / "t"), 320, family)
    j_fixture.build_tokenizer_files(str(tmp_path / "j"), 320, family)
    _same_files(str(tmp_path / "t"), str(tmp_path / "j"), hf_fixture.TOKENIZER_FILES)


def _tensors(path):
    with safetensors_np.SafetensorsFile(path) as f:
        return {name: f.numpy(name).copy() for name in f.keys()}


@pytest.mark.parametrize("model", TINY_FIXTURES)
def test_checkpoint_is_the_jax_fixtures(tmp_path, model):
    mine = hf_fixture.build_checkpoint(model, out_dir=str(tmp_path / "t"), seed=0)
    ref = j_fixture.build_checkpoint(model, out_dir=str(tmp_path / "j"), seed=0)
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(mine)) == names
    _same_files(mine, ref, [n for n in names if n.endswith(".json") or n == ".complete"])
    shards = [n for n in names if n.endswith(".safetensors")]
    assert shards
    for shard in shards:
        a, b = _tensors(os.path.join(mine, shard)), _tensors(os.path.join(ref, shard))
        assert list(a) == list(b)
        for name in a:
            assert a[name].dtype == b[name].dtype and np.array_equal(a[name], b[name]), name
        assert filecmp.cmp(os.path.join(mine, shard), os.path.join(ref, shard), shallow=False)


def test_checkpoint_is_idempotent(tmp_path):
    d = hf_fixture.build_checkpoint("bcg-hf/tiny", out_dir=str(tmp_path / "c"))
    stamp = os.path.getmtime(os.path.join(d, "model.safetensors"))
    assert hf_fixture.build_checkpoint("bcg-hf/tiny", out_dir=d) == d
    assert os.path.getmtime(os.path.join(d, "model.safetensors")) == stamp


def _game_config(C, backend):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=2, seed=3),
        engine=C.EngineConfig(backend=backend, model_name="bcg-hf/tiny", max_model_len=2048),
        llm=C.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
        metrics=C.MetricsConfig(save_results=False),
    )


def _play(sim):
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    decisions = [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds]
    return stats, decisions, votes


@pytest.fixture(scope="module")
def games(tmp_path_factory):
    import jax.numpy as jnp

    from bcg_tpu.engine.jax_engine import JaxEngine
    from bcg_tpu.models.configs import spec_for_model as j_spec
    from bcg_tpu.models.loader import load_checkpoint_params as j_load
    from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
    from bcg_tpu_torch.engine.tokenizer import HFTokenizer
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import load_checkpoint_params
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation

    root = tmp_path_factory.mktemp("hf_game")
    ckpt = hf_fixture.build_checkpoint("bcg-hf/tiny", out_dir=str(root / "bcg-hf--tiny"))
    old = os.environ.get("BCG_TPU_CHECKPOINT_DIR")
    os.environ["BCG_TPU_CHECKPOINT_DIR"] = str(root)
    try:
        jc, tc = _game_config(jcfg, "jax"), _game_config(tcfg, "torch")
        # Each package's loader reads the checkpoint's bf16 tensors into
        # f32, as tests/test_torch_game.py plays in f32: in bf16 the two
        # packages' sums round differently and a greedy near-tie of the
        # random tiny model flips (ROADMAP C-port-1).  The tokenizer is
        # the checkpoint's, through each package's discovery.
        tp = load_checkpoint_params(spec_for_model("bcg-hf/tiny"), "bcg-hf/tiny", "cpu",
                                    ckpt_dir=ckpt, dtype=torch.float32)
        jp = j_load(j_spec("bcg-hf/tiny"), "bcg-hf/tiny", dtype=jnp.float32, ckpt_dir=ckpt)
        tengine = TorchEngine(tc.engine, device="cpu", params=tp)
        assert isinstance(tengine.tokenizer, HFTokenizer)
        jsim = JSimulation(jc, engine=JaxEngine(jc.engine, params=jp))
        tsim = TSimulation(tc, engine=tengine)
        return (jsim,) + _play(jsim), (tsim,) + _play(tsim)
    finally:
        if old is None:
            del os.environ["BCG_TPU_CHECKPOINT_DIR"]
        else:
            os.environ["BCG_TPU_CHECKPOINT_DIR"] = old


def test_hf_tiny_game_statistics_identical(games):
    (_, jstats, _, _), (_, tstats, _, _) = games
    assert tstats == jstats
    assert len(tstats) == 51


def test_hf_tiny_game_decisions_and_votes_identical(games):
    (jsim, _, jdec, jvotes), (tsim, _, tdec, tvotes) = games
    assert tdec == jdec and tvotes == jvotes
    assert tdec and tvotes
    assert tsim.engine.failed_rows == jsim.engine.failed_rows


def test_experiments_build_a_missing_fixture(tmp_path, monkeypatch):
    from bcg_tpu_torch import experiments

    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(experiments, "run_preset",
                        lambda preset, **kw: calls.append(kw) or {"preset": "x", "aggregate": {}})
    experiments.main(["q1-baseline", "--model", "bcg-hf/tiny", "--backend", "fake",
                      "--runs", "1", "--rounds", "1"])
    assert os.path.exists(tmp_path / "checkpoints" / "bcg-hf--tiny" / ".complete")
    assert calls and calls[0]["model_name"] == "bcg-hf/tiny"
    with open(tmp_path / "checkpoints" / "bcg-hf--tiny" / "config.json") as f:
        assert json.load(f)["model_type"] == "qwen3"
