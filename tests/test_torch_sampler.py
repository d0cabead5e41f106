"""The port's fused guided sampler (plain version on the CPU) against the
JAX package's fused Pallas sampler (interpret mode) and its XLA masked
sampler, plus the port's GuidedBatch tables against the JAX ones.

Contract (the JAX package's own, tests/test_guided_sampler.py): greedy
rows are token-identical to both JAX samplers; sampled rows are
token-identical to the fused kernel when given the same per-row uniform
``u`` — reproduced here with the kernel's own ``split``/``uniform`` draw.
Both sides sum in f32 in different orders, so a draw landing within an
f32 rounding of a CDF boundary could differ; the seeded cases here do
not (no tolerance is applied to tokens).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bcg_tpu.engine.speculative import make_masked_sampler as j_masked_sampler
from bcg_tpu.guided.processor import GuidedBatch as JGuidedBatch, compile_schema as j_compile
from bcg_tpu.ops import guided_sampler as jgs
from bcg_tpu_torch.engine.speculative import make_masked_sampler as t_masked_sampler
from bcg_tpu_torch.guided.processor import GuidedBatch as TGuidedBatch, compile_schema as t_compile
from bcg_tpu_torch.ops import guided_sampler as tgs
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


EOS = 3


def _case(rng, B, V, n_dfa, n_states, minb_forbid=0.4):
    """Random sampler arguments with the GuidedBatch dtypes: int16
    tables/min_budget, dead (-1) states, near-exhausted budgets, a forbid
    token on a third of the rows (the JAX package's own test case)."""
    minb = rng.randint(1, 6, (n_dfa, n_states, V)).astype(np.int16)
    minb[rng.rand(n_dfa, n_states, V) < minb_forbid] = np.iinfo(np.int16).max
    return dict(
        logits=(rng.randn(B, V) * 3).astype(np.float32),
        tables=rng.randint(0, n_states, (n_dfa, n_states, V)).astype(np.int16),
        accepting=rng.rand(n_dfa, n_states) < 0.5,
        min_budget=minb,
        dfa_ids=rng.randint(0, n_dfa, (B,)).astype(np.int32),
        states=rng.randint(-1, n_states, (B,)).astype(np.int32),
        emitted=rng.randint(0, 12, (B,)).astype(np.int32),
        row_budget=rng.randint(2, 16, (B,)).astype(np.int32),
        forbid=np.where(rng.rand(B) < 0.33, rng.randint(0, V, B), -1).astype(np.int32),
    )


def _run_jax(sampler, a, temps, key):
    tok, st, _ = sampler(
        jnp.asarray(a["logits"]), jnp.asarray(a["states"]), key,
        jnp.asarray(a["emitted"]), jnp.asarray(a["tables"]),
        jnp.asarray(a["accepting"]), jnp.asarray(a["min_budget"]),
        jnp.asarray(a["dfa_ids"]), jnp.asarray(temps),
        jnp.asarray(a["row_budget"]), forbid=jnp.asarray(a["forbid"]),
    )
    return np.asarray(tok), np.asarray(st)


def _run_torch(sampler, a, temps, gen=None, **kw):
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    tok, st = sampler(
        t["logits"], t["states"], gen, t["emitted"], t["tables"], t["accepting"],
        t["min_budget"], t["dfa_ids"], torch.from_numpy(temps), t["row_budget"],
        forbid=t["forbid"], **kw,
    )
    return tok.numpy(), st.numpy()


GEOMETRIES = [
    pytest.param(512, 2, 8, id="v512"),
    pytest.param(300, 2, 5, id="offlane-v300"),
    pytest.param(256, 4, 40, id="wide-dfa"),
]


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("V,n_dfa,n_states", GEOMETRIES)
def test_greedy_rows_identical_to_both_jax_samplers(V, n_dfa, n_states, top_p):
    rng = np.random.RandomState(V + n_states)
    ref_xla = j_masked_sampler(EOS, top_p)
    ref_fused = jgs.make_fused_sampler(EOS, top_p, interpret=True)
    port = tgs.make_fused_sampler(EOS, top_p)
    port_plain = t_masked_sampler(EOS, top_p)
    for trial in range(4):
        a = _case(rng, 8, V, n_dfa, n_states)
        temps = np.zeros(8, np.float32)
        key = jax.random.PRNGKey(trial)
        t_x, s_x = _run_jax(ref_xla, a, temps, key)
        t_f, s_f = _run_jax(ref_fused, a, temps, key)
        t_p, s_p = _run_torch(port, a, temps, u=torch.zeros(8))
        t_q, s_q = _run_torch(port_plain, a, temps, gen=torch.Generator().manual_seed(0))
        np.testing.assert_array_equal(t_p, t_x)
        np.testing.assert_array_equal(t_p, t_f)
        np.testing.assert_array_equal(s_p, s_x)
        np.testing.assert_array_equal(t_q, t_x)
        np.testing.assert_array_equal(s_q, s_x)


@pytest.mark.parametrize("top_p", [1.0, 0.9])
@pytest.mark.parametrize("V,n_dfa,n_states", GEOMETRIES)
def test_sampled_rows_identical_to_fused_kernel_given_its_u(V, n_dfa, n_states, top_p):
    rng = np.random.RandomState(7 * V + n_states)
    ref = jgs.make_fused_sampler(EOS, top_p, interpret=True)
    port = tgs.make_fused_sampler(EOS, top_p)
    for trial in range(4):
        a = _case(rng, 8, V, n_dfa, n_states)
        temps = np.where(np.arange(8) % 2 == 0, 0.0, 0.7).astype(np.float32)
        key = jax.random.PRNGKey(100 + trial)
        # The kernel's own draw (guided_sampler.py make_fused_sampler).
        _, sub = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sub, (8,), jnp.float32))
        t_f, s_f = _run_jax(ref, a, temps, key)
        t_p, s_p = _run_torch(port, a, temps, u=torch.from_numpy(np.array(u)))
        np.testing.assert_array_equal(t_p, t_f)
        np.testing.assert_array_equal(s_p, s_f)


def test_dead_end_forces_eos():
    """A state with no legal token must emit EOS with state -1."""
    V, B = 256, 4
    port = tgs.make_fused_sampler(EOS, 1.0)
    minb = torch.full((1, 2, V), np.iinfo(np.int16).max, dtype=torch.int16)
    tok, st = port(
        torch.zeros((B, V)), torch.zeros(B, dtype=torch.int32), None,
        torch.zeros(B, dtype=torch.int32), torch.zeros((1, 2, V), dtype=torch.int16),
        torch.zeros((1, 2), dtype=torch.bool), minb, torch.zeros(B, dtype=torch.int32),
        torch.tensor([0.0, 0.5, 0.0, 1.0]), torch.full((B,), 8, dtype=torch.int32),
        u=torch.full((B,), 0.5),
    )
    assert tok.tolist() == [EOS] * B
    assert st.tolist() == [-1] * B


def test_sample_rows_plain_mirrors_kernel_contract():
    """Kernel-level function: any_tok is taken before the EOS patch and
    EOS is legal only where accepting."""
    V = 128
    logits = torch.zeros((2, V))
    logits[:, EOS] = 10.0
    minb = torch.ones((1, 1, V), dtype=torch.int16)
    meta_i = torch.tensor([[5, -1, 1, 0], [5, -1, 1, 1]], dtype=torch.int32)
    meta_f = torch.tensor([[1.0, 0.5], [1.0, 0.5]])
    z = torch.zeros(2, dtype=torch.int32)
    tok, any_tok = tgs.sample_rows(logits, minb, z, z, meta_i, meta_f, EOS, 1.0)
    assert tok.tolist()[0] != EOS and tok.tolist()[1] == EOS
    assert any_tok.tolist() == [True, True]


def test_guided_batch_tables_match_jax():
    schema = {
        "type": "object",
        "properties": {
            "decision": {"type": "string", "enum": ["stop", "continue"]},
            "value": {"type": "integer", "minimum": 0, "maximum": 50},
        },
        "required": ["decision", "value"],
        "additionalProperties": False,
    }
    vote = {
        "type": "object",
        "properties": {"decision": {"type": "string", "enum": ["stop", "continue"]}},
        "required": ["decision"], "additionalProperties": False,
    }
    token_bytes = [bytes([i]) for i in range(256)] + [b""] * 256
    jg = [j_compile(s, token_bytes, vocab_id=11) for s in (schema, vote, schema)]
    tg = [t_compile(s, token_bytes, vocab_id=11) for s in (schema, vote, schema)]
    jb, tb = JGuidedBatch(jg), TGuidedBatch(tg, device="cpu")
    assert tb.tables.dtype == torch.int16 and tb.min_budget.dtype == torch.int16
    np.testing.assert_array_equal(tb.tables.numpy(), np.asarray(jb.tables))
    np.testing.assert_array_equal(tb.accepting.numpy(), np.asarray(jb.accepting))
    np.testing.assert_array_equal(tb.min_budget.numpy(), np.asarray(jb.min_budget))
    np.testing.assert_array_equal(tb.dfa_ids.numpy(), np.asarray(jb.dfa_ids))
    np.testing.assert_array_equal(tb.init_states.numpy(), np.asarray(jb.init_states))
    # Same table-cache key: a second batch of the same schema set reuses
    # the device tables.
    again = TGuidedBatch(tg[:2], device="cpu")
    assert again.tables is tb.tables
    states = torch.tensor([0, -1, 2], dtype=torch.int32)
    toks = torch.tensor([ord("{"), ord("{"), ord('"')])
    np.testing.assert_array_equal(
        tb.step(states, toks).numpy(),
        np.asarray(jb.step(jnp.asarray(states.numpy()), jnp.asarray(toks.numpy()))),
    )
    perm = TGuidedBatch.permissive(3, 512)
    assert perm.tables.shape == (1, 1, 512) and bool(perm.accepting.all())
