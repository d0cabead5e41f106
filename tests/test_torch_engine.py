"""Engine-level parity: ``TorchEngine`` (on the CPU, through the kernels'
plain versions) against ``JaxEngine`` on the same weights.

Both engines get the same ``bcg-tpu/tiny-test`` weights, drawn by the JAX
initializer and handed to the port through ``params_from_numpy``.  The
weights stay f32 on both sides (the JAX engine accepts f32 params as
they are): the point here is that the engines build the same batches,
caches and masks and run the same token loop, so greedy text must be
IDENTICAL per row — no tolerance.  Covered: the decision and vote
schemas of the JAX engine's own tests, two system prompts (two prefix
cache entries), a two-level ``(core, tail)`` prompt, unguided
generation, a batch that pads to the next batch bucket, and the one
error that becomes per-row error dicts (``BudgetError``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.config import EngineConfig as JEngineConfig
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu_torch.config import EngineConfig
from bcg_tpu_torch.engine.torch_engine import BudgetError, TorchEngine
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
import _torch_jax_obs_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs several
    pytest workers on one machine, and torch's thread pools spinning
    against each other slow these CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


MODEL = "bcg-tpu/tiny-test"

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


def named_arrays(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", np.asarray(a)) for i, l in enumerate(v)
                    for n, a in l.items()]
        else:
            out.append((k, np.asarray(v)))
    return out


@pytest.fixture(scope="module")
def engines():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    je = JaxEngine(JEngineConfig(backend="jax", model_name=MODEL, max_model_len=2048),
                   params=jp)
    te = TorchEngine(EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048),
                     device="cpu", params=tp)
    yield je, te
    je.shutdown()
    te.shutdown()


def test_guided_json_identical_per_row(engines):
    je, te = engines
    prompts = [
        (f"You are agent_{i}. Reach consensus.",
         f"Round 1. Your value is {i * 7}. Decide." + " Think." * i,
         DECISION_SCHEMA if i % 2 else VOTE_SCHEMA)
        for i in range(5)
    ]
    prompts.append(("You are agent_9, a careful voter.", "Vote now.", VOTE_SCHEMA))
    a = je.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
    b = te.batch_generate_json(prompts, temperature=0.0, max_tokens=64)
    assert b == a
    assert te.last_decode_steps == je.last_decode_steps
    assert (te.total_rows, te.failed_rows) == (je.total_rows, je.failed_rows)
    for row, schema in zip(b, [p[2] for p in prompts]):
        assert set(row) == set(schema["required"])


def test_two_level_prefix_and_small_batch_identical(engines):
    """(core, tail) user prompts take the two-level cached prefix; three
    rows pad to the batch bucket of four."""
    je, te = engines
    core = "Proposals: agent_0=12, agent_1=30, agent_2=12. History: none."
    prompts = [("You are a voter.", (core, f" You are agent_{i}. Vote."), VOTE_SCHEMA)
               for i in range(3)]
    a = je.batch_generate_json(prompts, temperature=0.0, max_tokens=32)
    b = te.batch_generate_json(prompts, temperature=0.0, max_tokens=32)
    assert b == a
    assert te.last_decode_steps == je.last_decode_steps


def test_free_generation_identical(engines):
    je, te = engines
    prompts = ["Hello there", "The consensus value is"]
    assert te.batch_generate(prompts, temperature=0.0, max_tokens=12) == \
        je.batch_generate(prompts, temperature=0.0, max_tokens=12)
    assert te.generate("Say a number.", max_tokens=8, system_prompt="Be brief.") == \
        je.generate("Say a number.", max_tokens=8, system_prompt="Be brief.")


def test_budget_error_becomes_error_dicts(engines):
    """A token budget that leaves no room for a prompt is the only error
    that turns into per-row error dicts; the counters count the rows."""
    je, te = engines
    prompts = [("sys", "user", VOTE_SCHEMA)] * 2
    before = (te.total_rows, te.failed_rows)
    a = je.batch_generate_json(prompts, temperature=0.0, max_tokens=2047)
    b = te.batch_generate_json(prompts, temperature=0.0, max_tokens=2047)
    assert b == a
    assert [r["error"] for r in b] == ["generation_failed"] * 2
    assert (te.total_rows, te.failed_rows) == (before[0] + 2, before[1] + 2)


def test_other_errors_propagate(engines, monkeypatch):
    """Anything but BudgetError raises out of batch_generate_json."""
    _, te = engines

    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(te, "_decode_batch", boom)
    with pytest.raises(RuntimeError, match="kernel failed"):
        te.batch_generate_json([("sys", "user", VOTE_SCHEMA)], temperature=0.0, max_tokens=8)
    assert issubclass(BudgetError, ValueError)
