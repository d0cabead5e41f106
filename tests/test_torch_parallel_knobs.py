"""Every engine the port serves on one device, over a mesh of two ranks
(ROADMAP A13b items 1, 2 and 4): quantized weights, quantized caches and
the fast-forward and speculative loops under tp, sp and dp, against the
JAX engine on the same mesh shape.

The configurations are the card's one-device paths PERF.md names P2-P9
(the paged ones, P5-P7, under tp and dp in
``tests/test_torch_parallel_paged.py``), each under the meshes it
composes with, on ``tiny-test`` (``PRNGKey(5)``) and, where the kv heads
replicate under tp, ``tiny-dh128`` (``PRNGKey(1)``), the JAX
initializer's weights in f32 on both sides.  The port's arms run in one
gloo world of 2 ranks started once for the module
(``tests/_torch_parallel_worker.knob_cases``).  Held:

* the greedy outputs of a batch of decision and vote rows, token for
  token, against ``JaxEngine`` on the same mesh, and the same on every
  rank (C-port-1's tolerances stand behind them: each greedy token is
  the argmax of logits within 1e-4 at a prefill and 1e-2 at a decode
  step of the JAX model's; under sp C-port-8's);
* the dense int4 cache and the paged pool under sp raise the JAX
  engine's ``ValueError``s, word for word.
"""

import pytest
import torch

import bcg_tpu.config as jcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu_torch.config import EngineConfig
from bcg_tpu_torch.engine.torch_engine import TorchEngine
import _torch_jax_obs_state
import _torch_knob_harness as h

ARMS = [
    h.arm("P2", "tp"), h.arm("P4", "tp"), h.arm("P8", "tp"), h.arm("P9", "tp"),
    h.arm("P9", "tp", model=h.DH), h.arm("P3", "tp", model=h.DH),
    h.arm("kv4", "tp", kv_cache_dtype="int4", decode_fast_forward=True),
    h.arm("P2", "sp"), h.arm("P3", "sp"), h.arm("P8", "sp"), h.arm("P9", "sp"),
    h.arm("P3", "dp"), h.arm("P4", "dp"), h.arm("P8", "dp"),
    h.arm("kv4", "dp", kv_cache_dtype="int4", spec_decode=True, quantization="int4"),
]
PROMPTS = h.round_prompts(1)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    return h.jax_weights((h.TT, h.DH))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, weights):
    return h.run_world(str(tmp_path_factory.mktemp("knobs")), ARMS, weights, PROMPTS)


@pytest.mark.parametrize("arm", ARMS, ids=[a["name"] for a in ARMS])
def test_greedy_outputs_token_identical_to_jax_on_every_rank(ranks, weights, arm):
    (want, _), = h.jax_rounds(arm, weights[arm["model"]], PROMPTS)
    for res in ranks[arm["name"]]:
        assert h.json.loads(str(res["r0"])) == want
        assert int(res["failed"]) == 0
    for row, prompt in zip(want, PROMPTS[0]):
        assert set(row) == set(prompt[2]["required"])


@pytest.mark.parametrize("knob", [dict(kv_cache_dtype="int4"), dict(paged_kv=True)],
                         ids=["int4-cache", "paged"])
def test_sp_refusals_match_jax(weights, knob):
    with pytest.raises(ValueError) as j_err:
        JaxEngine(jcfg.EngineConfig(backend="jax", model_name=h.TT, max_model_len=2048,
                                    sequence_parallel_size=2, **knob),
                  mesh=h.jax_mesh(dict(sequence_parallel_size=2)), params=weights[h.TT])
    with pytest.raises(ValueError) as t_err:
        TorchEngine(EngineConfig(backend="torch", model_name=h.TT, sequence_parallel_size=2,
                                 **knob), device="cpu")
    assert str(t_err.value) == str(j_err.value)
