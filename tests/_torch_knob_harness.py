"""What the mesh knob tests share (not a pytest module): the JAX
initializer's weights, the prompts of each round, the port's world over
``_torch_parallel_worker.knob_cases`` and the JAX engine on the same mesh
shape over the same rounds.

A round's prompts extend the last round's (the same system prompts, a
longer history), so a paged engine's second round hits the first's radix
chains.  Outputs are greedy, held token for token.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

import bcg_tpu.config as jcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.parallel.mesh import build_mesh as j_build_mesh
from bcg_tpu_torch.parallel.distributed import spawn_world

TESTS = os.path.dirname(os.path.abspath(__file__))
TT, DH = "bcg-tpu/tiny-test", "bcg-tpu/tiny-dh128"
KEYS = {TT: 5, DH: 1}
MAX_TOKENS = 64

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


def round_prompts(n_rounds=2, rows=6):
    """Each round's ``(system, user, schema)`` rows.  Round 1 is the batch
    of ``tests/test_torch_parallel_engine.py`` (on which the one-device
    engines of both packages agree token for token for every knob here);
    round ``r`` carries round ``r - 1``'s user text as history, so a paged
    engine's later round extends the earlier one's radix chains."""
    rounds = []
    for r in range(n_rounds):
        history = "".join(f"Round {k + 1}: values were {7 * k + 3} and {5 * k + 11}. "
                          for k in range(r))
        rounds.append([
            (f"You are agent_{i % 2}. Reach consensus.",
             f"{history}Round {r + 1}. Your value is {i * 7}. Decide." + " Think." * i,
             DECISION_SCHEMA if i % 2 else VOTE_SCHEMA)
            for i in range(rows)])
    return rounds


PAGED = dict(paged_kv=True)
# The one-device paths PERF.md names P2-P9 (the card's game paths), as
# engine knobs.
KNOBS = {
    "P2": dict(kv_cache_dtype="int8", decode_fast_forward=True, guided_compact_json=True),
    "P3": dict(spec_decode=True),
    "P4": dict(kv_cache_dtype="int8"),
    "P5": dict(PAGED),
    "P6": dict(PAGED, kv_cache_dtype="int4", decode_fast_forward=True,
               guided_compact_json=True),
    "P7": dict(PAGED, kv_cache_dtype="int8", spec_decode=True),
    "P8": dict(quantization="int8", kv_cache_dtype="int8", decode_fast_forward=True,
               guided_compact_json=True),
    "P9": dict(quantization="int4"),
}
MESHES = {"tp": dict(tensor_parallel_size=2), "sp": dict(sequence_parallel_size=2),
          "dp": dict(data_parallel_size=2)}


def arm(path, mesh, model=TT, rounds=1, **extra):
    kw = dict(KNOBS.get(path, {}), **extra, **MESHES[mesh])
    short = model.split("/")[-1]
    return dict(name=f"{short}_{path}_{mesh}", model=model, kw=kw, rounds=rounds,
                mesh=mesh)


def named(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", np.asarray(a)) for i, l in enumerate(v)
                    for n, a in l.items()]
        else:
            out.append((k, np.asarray(v)))
    return out


def jax_weights(models):
    return {m: jt.init_params(j_spec(m), jax.random.PRNGKey(KEYS[m]), dtype=jnp.float32)
            for m in models}


def run_world(tmp, arms, weights, prompts, timeout_s=300):
    """The port's 2-rank gloo world over ``knob_cases``: per arm, each
    rank's results (``{key: value}`` without the arm's prefix)."""
    inputs = os.path.join(tmp, "inputs")
    for model, jp in weights.items():
        np.savez(f"{inputs}_{model.split('/')[-1]}.npz", **dict(named(jp)))
    with open(inputs + ".json", "w") as f:
        json.dump(dict(arms=arms, rounds=prompts, max_tokens=MAX_TOKENS), f)
    out = os.path.join(tmp, "world")
    os.makedirs(out)
    spawn_world("_torch_parallel_worker:knob_cases", 2, timeout_s=timeout_s,
                args=dict(inputs=inputs, out=out), sys_path=[TESTS], device_type="cpu")
    per_rank = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(2)]
    return {a["name"]: [{k.split("/", 1)[1]: v for k, v in r.items()
                         if k.startswith(a["name"] + "/")} for r in per_rank] for a in arms}


def jax_mesh(kw):
    return j_build_mesh(dp=kw.get("data_parallel_size", 1),
                        tp=kw.get("tensor_parallel_size", 1),
                        sp=kw.get("sequence_parallel_size", 1))


def jax_rounds(a, jp, prompts):
    """``JaxEngine`` of the arm's knobs on the same mesh shape over the
    same rounds: per round the results and (paged) the pool statistics."""
    engine = JaxEngine(jcfg.EngineConfig(backend="jax", model_name=a["model"],
                                         max_model_len=2048, **a["kw"]),
                       mesh=jax_mesh(a["kw"]), params=jp)
    out = []
    try:
        for rows in prompts[:a["rounds"]]:
            results = engine.batch_generate_json(rows, temperature=0.0, max_tokens=MAX_TOKENS)
            pool = engine.kv_pool_stats() if hasattr(engine, "kv_pool_stats") else None
            out.append((results, None if pool is None else {
                k: pool[k] for k in ("blocks_free", "blocks_resident", "prefix_hit_rate")}))
    finally:
        engine.shutdown()
    return out
