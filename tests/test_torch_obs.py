"""The observability plane of the PyTorch port against the JAX package's.

* The framework-free modules are the JAX package's, copied: each source
  equals its original once ``bcg_tpu.`` reads ``bcg_tpu_torch.``; every
  environment flag the observability modules read is registered.
* A tiny greedy game on both engines (``bcg-tpu/tiny-test``, the same f32
  weights, every flag on): the same ``BCG_TPU_GAME_EVENTS`` stream once
  the time, run id, host and pid fields (and the engine's backend name
  and the process-local game counter) are dropped; the same span names;
  the same host syncs per seam, the port adding its done polls.
* The port's seams on the CPU: host-sync counts equal a formula of the
  loops' steps; a new padded batch gives one compile cause record naming
  its argument and a repeat none; the launch census counts ``num_layers``
  attention calls and one sampler call a decode step; the ledger's
  charges equal ``param_bytes`` and the batch's KV bytes and fall to zero
  at shutdown; the profiler's phases are the same with tracing on and
  off; ``--profile-dir`` and ``BCG_TPU_PROFILE`` write traces.
* A sampled game's decisions, votes and statistics are the same with
  each observability flag on, and with all of them, as with none.
"""

import json
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.obs import (counters as j_counters, game_events as j_game_events,
                         hostsync as j_hostsync, tracer as j_tracer)
import _torch_jax_obs_state
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu_torch.engine.torch_engine import _DONE_CHECK, TorchEngine
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.obs import (compile as obs_compile, counters as obs_counters,
                               game_events as obs_game_events, hlo as obs_hlo,
                               hostsync as obs_hostsync, ledger as obs_ledger,
                               tracer as obs_tracer)
from bcg_tpu_torch.runtime import envflags
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "bcg-tpu/tiny-test"


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


_PORT_RESETS = (obs_tracer.reset, obs_hostsync.reset, obs_compile.reset, obs_hlo.reset,
                obs_game_events.reset_sink)
_JAX_RESETS = (j_tracer.reset, j_hostsync.reset, j_game_events.reset_sink)


def _reset_all():
    for fn in _PORT_RESETS + _JAX_RESETS:
        fn()


@pytest.fixture()
def obs_env(monkeypatch):
    """Flags set by the test take effect (the modules read them once);
    on the way out every module re-reads an environment without them."""
    _reset_all()
    yield monkeypatch
    monkeypatch.undo()
    _reset_all()


# ------------------------------------------------------------ the copies

COPIES = ["obs/counters.py", "obs/tracer.py", "obs/ledger.py", "obs/fleet.py", "obs/export.py",
          "obs/game_events.py", "obs/alerts.py", "runtime/resilience.py",
          "runtime/checkpoint.py", "engine/tokenizer.py"]


# The static analyzer's exemptions of the JAX modules live in the lint
# baseline, keyed by their paths; a copy carries the same ones inline.
_LINT_IGNORE = re.compile(r"  # lint: ignore\[[A-Z0-9-]+\][^\n]*")


# Top-level definitions a copied module's port writes itself, and its
# docstring: the port's HFTokenizer reads tokenizer.json with its own
# reader (engine/tokenizer_json.py, ROADMAP A15) instead of wrapping
# transformers.  Every other statement stays the JAX module's.
PORT_OWN = {"engine/tokenizer.py": {
    "HFTokenizer", "_gpt2_byte_decoder", "_SPECIAL_KEYS", "_CLASS_DEFAULTS", "_content",
    "_read_json", "_clean_up_tokenization"}}


def _copied_part(source, own):
    """The module's top-level statements in order, as source, without its
    docstring and the definitions named in ``own``."""
    import ast

    tree = ast.parse(source)
    out = []
    for k, node in enumerate(tree.body):
        if k == 0 and isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant):
            continue
        names = {getattr(node, "name", None)} | {
            t.id for t in getattr(node, "targets", []) if isinstance(t, ast.Name)}
        if names & own:
            continue
        out.append(ast.get_source_segment(source, node))
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copied_module_equals_the_jax_one(rel):
    orig = open(os.path.join(ROOT, "bcg_tpu", rel), encoding="utf-8").read()
    port = open(os.path.join(ROOT, "bcg_tpu_torch", rel), encoding="utf-8").read()
    orig = _LINT_IGNORE.sub("", orig).replace("bcg_tpu.", "bcg_tpu_torch.")
    port = _LINT_IGNORE.sub("", port)
    if rel in PORT_OWN:
        assert _copied_part(port, PORT_OWN[rel]) == _copied_part(orig, PORT_OWN[rel])
        assert len(_copied_part(port, PORT_OWN[rel])) >= 8
    else:
        assert port == orig


OBS_MODULES = ["counters", "tracer", "ledger", "fleet", "export", "game_events", "alerts",
               "hostsync", "compile", "hlo"]


@pytest.mark.parametrize("mod", OBS_MODULES + ["resilience"])
def test_every_flag_the_modules_read_is_registered(mod):
    sub = "runtime" if mod == "resilience" else "obs"
    names = set()
    for pkg in ("bcg_tpu", "bcg_tpu_torch"):
        text = open(os.path.join(ROOT, pkg, sub, f"{mod}.py"), encoding="utf-8").read()
        names |= set(re.findall(r'envflags\.\w+\(\s*"(BCG_TPU_\w+)"', text))
    missing = sorted(n for n in names if n not in envflags.REGISTRY)
    assert not missing


# ------------------------------------------------------------ the game

def _config(C, backend, rounds=2):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=rounds, seed=3),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048),
        llm=C.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
        metrics=C.MetricsConfig(save_results=False),
    )


def _named_arrays(tree):
    out = []
    for k, v in tree.items():
        if k == "layers":
            out += [(f"layers.{i}.{n}", a) for i, l in enumerate(v) for n, a in l.items()]
        else:
            out.append((k, v))
    return [(n, np.asarray(a)) for n, a in out]


@pytest.fixture(scope="module")
def weights():
    jp = jt.init_params(j_spec(MODEL), jax.random.PRNGKey(5), dtype=jnp.float32)
    tp = params_from_numpy(_named_arrays(jp), spec_for_model(MODEL), "cpu", torch.float32)
    return jp, tp


def _events(path):
    """The stream without its times, run ids, hosts, pids, the engine's
    backend name, the process-local game counter and the stream's own
    path in the manifest's flags."""
    drop = {"ts", "run_id", "host", "pid", "duration_ms", "game", "backend"}
    out = []
    for line in open(path):
        rec = json.loads(line)
        if rec["event"] == "manifest":
            assert rec["flags"].pop("BCG_TPU_GAME_EVENTS") == path
        out.append({k: v for k, v in rec.items() if k not in drop})
    return out


@pytest.fixture(scope="module")
def games(weights, tmp_path_factory):
    """One tiny greedy game per package with every observability flag on."""
    jp, tp = weights
    tmp = tmp_path_factory.mktemp("obs_games")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BCG_TPU_TRACE", "1")
        mp.setenv("BCG_TPU_HOSTSYNC", "1")
        for pkg, C, Sim, make, resets, ev in (
            ("jax", jcfg, JSimulation, lambda c: JaxEngine(c.engine, params=jp), _JAX_RESETS,
             j_game_events),
            ("torch", tcfg, TSimulation,
             lambda c: TorchEngine(c.engine, device="cpu", params=tp), _PORT_RESETS,
             obs_game_events),
        ):
            path = str(tmp / f"{pkg}.jsonl")
            mp.setenv("BCG_TPU_GAME_EVENTS", path)
            for fn in resets:
                fn()
            cfg = _config(C, pkg)
            sim = Sim(cfg, engine=make(cfg))
            counters = (j_counters if pkg == "jax" else obs_counters)
            before = counters.snapshot()
            stats = sim.run()
            tracer = j_tracer if pkg == "jax" else obs_tracer
            out[pkg] = dict(stats=stats, spans=tracer.summarize(),
                            hostsync=counters.delta(before), sim=sim)
            ev.reset_sink()   # drains the stream to its file
            out[pkg]["events"] = _events(path)
    _reset_all()
    return out


def test_game_event_streams_are_identical(games):
    j, t = games["jax"], games["torch"]
    assert t["stats"] == j["stats"]
    assert t["events"] == j["events"]
    kinds = [e["event"] for e in t["events"]]
    assert kinds[0] == "manifest" and "game_start" in kinds and kinds[-1] == "game_end"
    assert kinds.count("round_end") == t["stats"]["total_rounds"] >= 1
    assert {"decision", "deliveries", "vote"} <= set(kinds)


def test_tracer_records_the_jax_engines_span_names(games):
    j, t = games["jax"]["spans"], games["torch"]["spans"]
    assert set(t) == set(j)
    assert {"round", "decide", "vote", "engine.prefill", "engine.decode"} <= set(t)
    for name in ("round", "decide", "vote", "engine.prefill", "engine.decode"):
        assert t[name]["count"] == j[name]["count"], name


def test_host_syncs_per_seam_match_the_jax_engine(games):
    j, t = games["jax"]["hostsync"], games["torch"]["hostsync"]
    j_sites = _table(j, "engine.hostsync.site.")
    port_sites = _table(t, "engine.hostsync.site.")
    polls = port_sites.pop("done_poll")
    assert port_sites == j_sites and j_sites["decode_readback"] > 0
    assert polls >= j_sites["decode_readback"]   # one poll a loop, at least
    assert "engine.hostsync.unattributed" not in t
    # Every sync of the game falls inside a round window.
    assert t["game.host_syncs.count"] == games["torch"]["stats"]["total_rounds"]
    buckets = _table(t, "game.host_syncs.bucket.")
    assert sum(buckets.values()) >= t["game.host_syncs.count"]


# ------------------------------------------------------------ engine seams

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


def _table(snap, prefix):
    return {k[len(prefix):]: v for k, v in snap.items() if k.startswith(prefix) and v}


def _prompts(n, schema=DECISION_SCHEMA):
    return [("You are agent_1.", f"Your value is {v}. Decide.", schema) for v in range(n)]


def _engine(tp, **knobs):
    return TorchEngine(tcfg.EngineConfig(backend="torch", model_name=MODEL,
                                         max_model_len=2048, **knobs),
                       device="cpu", params=tp)


LOOPS = {"plain": ({}, "_decode_loop", 1), "ff": (dict(decode_fast_forward=True),
                                                  "_ff_decode_loop", 0),
         "spec": (dict(spec_decode=True), "_spec_decode_loop", 0)}


@pytest.mark.parametrize("loop", list(LOOPS))
def test_host_sync_counts_follow_the_loop_steps(weights, obs_env, loop):
    """Per call: one prefill barrier, decode readback and steps readback
    (two spec readbacks on the speculative loop), and one done poll every
    _DONE_CHECK steps — up to the step after the last row finished, or to
    the end of the loop."""
    knobs, method, short = LOOPS[loop]
    obs_env.setenv("BCG_TPU_HOSTSYNC", "1")
    _reset_all()
    eng = _engine(weights[1], **knobs)
    calls = []
    orig = getattr(eng, method)

    def loop_fn(*args, **kw):
        ret = orig(*args, **kw)
        calls.append((int(ret[1]), args[8]))   # (steps, max_new)
        return ret

    setattr(eng, method, loop_fn)
    before = obs_counters.snapshot()
    eng.batch_generate_json(_prompts(3), temperature=0.0, max_tokens=96)
    eng.batch_generate_json(_prompts(2, VOTE_SCHEMA), temperature=0.0, max_tokens=24)
    assert all(s > 0 for s, _ in calls)
    polls = sum(min(math.ceil(s / _DONE_CHECK) + 1, (m - 1 - short) // _DONE_CHECK + 1)
                for s, m in calls)
    want = {"prefill_barrier": len(calls), "decode_readback": len(calls),
            "steps_readback": len(calls), "done_poll": polls}
    if loop == "spec":
        want["spec_readback"] = 2 * len(calls)
    delta = obs_counters.delta(before)
    assert _table(delta, "engine.hostsync.site.") == want
    assert delta["engine.hostsync.total"] == sum(want.values())
    assert "engine.hostsync.unattributed" not in delta
    entry = {"plain": "decode_loop", "ff": "ff_decode_loop", "spec": "spec_decode_loop"}[loop]
    assert _table(delta, "engine.hostsync.span.") == {
        "jit_prefill": len(calls), f"jit_{entry}": sum(want.values()) - len(calls)}


def test_new_padded_batch_gives_one_cause_record(weights, obs_env):
    obs_env.setenv("BCG_TPU_COMPILE_OBS", "1")
    _reset_all()
    eng = _engine(weights[1])
    before = obs_counters.snapshot()
    eng.batch_generate_json(_prompts(3), temperature=0.0, max_tokens=16)   # pads to 4
    assert obs_compile.summary()["cache_entries"] == 1
    assert obs_compile.cause_records() == []
    eng.batch_generate_json(_prompts(5), temperature=0.0, max_tokens=16)   # pads to 8
    records = obs_compile.cause_records()
    assert len(records) == 1
    assert records[0]["entry"] == "pad_batch" and records[0]["arg"] == "batch"
    assert (records[0]["old"], records[0]["new"], records[0]["cause"]) == (4, 8, "shape")
    eng.batch_generate_json(_prompts(3), temperature=0.0, max_tokens=16)   # a repeat
    assert len(obs_compile.cause_records()) == 1
    assert obs_compile.summary()["cache_entries"] == 2
    assert obs_counters.delta(before)["engine.retrace_cause.shape"] == 1


CENSUS = {"plain": ({}, "decode_loop", "decode_attention"),
          "ff": (dict(decode_fast_forward=True), "ff_decode_loop", "chunk_decode_attention"),
          "paged": (dict(paged_kv=True), "paged_decode_loop", "paged_attention"),
          "int8": (dict(kv_cache_dtype="int8"), "decode_loop", "decode_attention_int8")}


@pytest.mark.parametrize("case", list(CENSUS))
def test_census_counts_a_decode_steps_calls(weights, obs_env, case):
    knobs, entry, kind = CENSUS[case]
    obs_env.setenv("BCG_TPU_HLO_CENSUS", "1")
    _reset_all()
    eng = _engine(weights[1], **knobs)
    eng.batch_generate_json(_prompts(3), temperature=0.0, max_tokens=96)
    census = obs_hlo.snapshot()[entry]
    layers = spec_for_model(MODEL).num_layers
    assert census["backend"] == "cpu"
    assert census["calls"] == {kind: layers, "guided_sampler": 1}
    assert census["launches"] == {}     # the CPU runs the plain versions
    assert census["step_custom_calls"] == layers + 1
    assert obs_counters.value(f"engine.hlo.{entry}.calls_{kind}") == layers


def test_census_is_off_by_default(weights, obs_env):
    eng = _engine(weights[1])
    eng.batch_generate_json(_prompts(2), temperature=0.0, max_tokens=16)
    assert obs_hlo.snapshot() == {}


@pytest.mark.parametrize("knobs", [{}, dict(spec_decode=True), dict(paged_kv=True)])
def test_ledger_charges_params_and_kv_bytes_and_credits_them(weights, knobs):
    # Keys are engine identities: an engine collected without shutdown()
    # keeps its charge, and a new one may reuse its id; start clean.
    obs_ledger.reset()
    before = obs_ledger.snapshot()

    def delta(snap, key):
        return (snap[key] or 0) - (before[key] or 0)

    eng = _engine(weights[1], **knobs)
    assert delta(obs_ledger.snapshot(), "params_bytes") == eng._param_bytes
    seen = []
    method = "_spec_decode_loop" if knobs.get("spec_decode") else "_decode_loop"
    orig = getattr(eng, method)

    def loop_fn(*args, **kw):
        seen.append(obs_ledger.snapshot())
        return orig(*args, **kw)

    setattr(eng, method, loop_fn)
    eng.batch_generate_json(_prompts(3), temperature=0.0, max_tokens=24)
    during = seen[0]
    kv = delta(during, "kv_cache_bytes") + delta(during, "spec_slots_bytes")
    assert kv == eng.max_kv_cache_bytes > 0
    assert (delta(during, "spec_slots_bytes") > 0) == bool(knobs.get("spec_decode"))
    after = obs_ledger.snapshot()
    assert delta(after, "kv_cache_bytes") == delta(after, "spec_slots_bytes") == 0
    if knobs.get("paged_kv"):
        pool = eng.kv_pool_stats()
        resident = pool["blocks_resident"] * eng._paged.block_bytes_dev
        assert delta(after, "prefix_cache_bytes") == resident > 0
    else:
        assert delta(after, "prefix_cache_bytes") == eng._prefix_bytes > 0
    eng.shutdown()
    end = obs_ledger.snapshot()
    for key in ("params_bytes", "kv_cache_bytes", "prefix_cache_bytes", "spec_slots_bytes"):
        assert delta(end, key) == 0, key


def test_profiler_phases_are_the_same_with_tracing_on_and_off(weights, obs_env):
    def play():
        cfg = _config(tcfg, "torch", rounds=1)
        sim = TSimulation(cfg, engine=_engine(weights[1]))
        sim.run()
        return sim.profiler

    off = play()
    obs_env.setenv("BCG_TPU_TRACE", "1")
    _reset_all()
    on = play()
    assert on.phase_counts == off.phase_counts and set(on.phase_seconds) == set(off.phase_seconds)
    assert all(v > 0 for v in on.phase_seconds.values())
    spans = obs_tracer.summarize()
    assert all(spans[name]["count"] == n for name, n in on.phase_counts.items())
    assert obs_tracer.current() is None


OBS_FLAGS = ("BCG_TPU_TRACE", "BCG_TPU_HOSTSYNC", "BCG_TPU_COMPILE_OBS", "BCG_TPU_HLO_CENSUS",
             "BCG_TPU_GAME_EVENTS")


def _sampled_game(tp):
    """One round of a sampled game (the default temperatures and top-p):
    its decisions, votes and statistics."""
    cfg = tcfg.BCGConfig(
        game=tcfg.GameConfig(num_honest=2, num_byzantine=1, max_rounds=1, seed=0),
        engine=tcfg.EngineConfig(backend="torch", model_name=MODEL, max_model_len=2048),
        llm=tcfg.LLMConfig(),
        metrics=tcfg.MetricsConfig(save_results=False),
    )
    sim = TSimulation(cfg, engine=_engine(tp))
    votes, close = [], sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    return [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds], votes, stats


@pytest.fixture(scope="module")
def sampled_game_off(weights):
    _reset_all()
    return _sampled_game(weights[1])


@pytest.mark.parametrize("flags", [(f,) for f in OBS_FLAGS] + [OBS_FLAGS],
                         ids=[f[len("BCG_TPU_"):].lower() for f in OBS_FLAGS] + ["all"])
def test_obs_flags_change_no_token_of_a_sampled_game(weights, sampled_game_off, obs_env,
                                                      tmp_path, flags):
    for flag in flags:
        obs_env.setenv(flag, str(tmp_path / "events.jsonl")
                       if flag == "BCG_TPU_GAME_EVENTS" else "1")
    _reset_all()
    assert _sampled_game(weights[1]) == sampled_game_off


def test_cli_profile_dir_writes_a_trace(tmp_path, obs_env, capsys):
    from bcg_tpu_torch import cli

    out = tmp_path / "prof"
    rc = cli.main(["--honest", "2", "--byzantine", "0", "--rounds", "1", "--model", "tiny-test",
                   "--device", "cpu", "--no-save", "--profile-dir", str(out)])
    assert rc == 0
    trace = json.load(open(out / "trace.json"))
    assert trace["traceEvents"]


def test_profile_window_writes_a_trace_and_manifest(tmp_path, obs_env):
    """The window opens at round 1 and closes after it (the orchestrator
    wraps each round in ``profile_span``; the game tests drive that)."""
    obs_env.setenv("BCG_TPU_PROFILE", str(tmp_path / "win"))
    obs_env.setenv("BCG_TPU_PROFILE_ROUNDS", "1")
    _reset_all()
    with obs_compile.profile_span("round", 1):
        torch.ones(64).cumsum(0)
    manifest = json.load(open(tmp_path / "win" / "manifest.json"))
    assert manifest["kind"] == "profile" and manifest["first_index"] == 1
    events = json.load(open(tmp_path / "win" / "trace.json"))["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with obs_compile.profile_span("round", 2):   # past the window: nothing starts
        assert not torch.autograd._profiler_enabled()
