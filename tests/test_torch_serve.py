"""The serving tier of the PyTorch port (ROADMAP A11) against the JAX
package's.

* The framework-free modules are the JAX package's, copied: each source
  equals its original once ``bcg_tpu.`` reads ``bcg_tpu_torch.``, except
  in the functions (and docstrings) named in ``COPIES``, where the port
  names a module it does not have yet or the torch device; every
  environment flag the new modules read is registered.
* Fake-engine games (one per policy, four concurrent through the lockstep
  collective proxy, four through the serving scheduler, one with fault
  injection) give identical statistics in both packages, and the serving
  and collective proxies agree.
* Greedy ``bcg-tpu/tiny-test`` games on real engines: two concurrent
  games on ``JaxEngine`` and on ``TorchEngine(device="cpu")`` over the
  same weights give the same decisions, votes and statistics; a game's
  decision and vote rows are token-identical alone and merged with
  another game's rows; three served games each equal their solo runs;
  the derived row cap bounds every merged dispatch under a tight memory
  limit; a hung dispatch makes the supervisor rebuild the engine once
  and the games still complete.
* The entry points: ``run_simulation`` builds a ``TorchEngine`` with no
  backend named, ``BCG_TPU_SERVE=1`` wraps it, ``run_preset`` runs
  concurrent games on the CPU, ``create_engine`` builds the fake and the
  fault-injecting engines and checks the fault rate before any boot.

Every test that starts threads joins them with a timeout and closes its
scheduler, and fails rather than waits.
"""

import ast
import os
import random
import re
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bcg_tpu.config as jcfg
import bcg_tpu_torch.config as tcfg
from bcg_tpu import api as j_api
from bcg_tpu.engine import collective as j_collective
from bcg_tpu.engine.fake import FakeEngine as JFakeEngine
from bcg_tpu.engine.jax_engine import JaxEngine
from bcg_tpu.models import transformer as jt
from bcg_tpu.models.configs import spec_for_model as j_spec
from bcg_tpu.runtime.orchestrator import BCGSimulation as JSimulation
from bcg_tpu.serve import engine as j_serve
from bcg_tpu_torch import api as t_api
from bcg_tpu_torch.engine import collective as t_collective
from bcg_tpu_torch.engine.fake import BYZANTINE_POLICIES, HONEST_POLICIES
from bcg_tpu_torch.engine.fake import FakeEngine as TFakeEngine
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.models.configs import spec_for_model
from bcg_tpu_torch.models.convert import params_from_numpy
from bcg_tpu_torch.runtime import envflags, resilience
from bcg_tpu_torch.runtime.orchestrator import BCGSimulation as TSimulation
from bcg_tpu_torch.serve import ServingEngine, engine as t_serve
from bcg_tpu_torch.serve.scheduler import derive_row_cap
import _torch_jax_obs_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "bcg-tpu/tiny-test"
JOIN_S = 120.0


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


# ------------------------------------------------------------ the copies

# Module -> the functions, methods and docstrings where the port's copy
# may differ from its original: the sweep builds its engines on a torch
# device, joins its multi-process world through parallel/distributed.py
# and keeps a cooperative game's ranks in step; over an engine on a mesh
# the serving proxy leads from rank 0 and the other ranks follow
# (serve/mesh.py), unless its caller built the scheduler: its
# constructor, shutdown and run_serving_simulations.  The fake
# engine is held whole.
COPIES = {
    "engine/fault.py": (),
    "engine/fake.py": (),
    "engine/collective.py": (),
    "serve/__init__.py": (),
    "serve/engine.py": ("ServingEngine.__init__", "ServingEngine.shutdown",
                        "run_serving_simulations"),
    "serve/scheduler.py": (),
    "sweep/__init__.py": (),
    "sweep/spec.py": (),
    "sweep/controller.py": ("SweepController.__doc__", "SweepController.__init__",
                            "SweepController._group_for", "run_sweep"),
    "sweep/__main__.py": ("__doc__", "main"),
}


# The static analyzer's exemptions of the JAX modules live in the lint
# baseline, keyed by their paths; a copy carries the same ones inline.
_LINT_IGNORE = re.compile(r"  # lint: ignore\[[A-Z0-9, -]+\][^\n]*")


def _parts(src, names):
    """``src`` with the named top-level functions, methods, class
    docstrings (``Class.__doc__``) and module docstring (``__doc__``)
    cut out, and the cut parts by name."""
    tree = ast.parse(src)
    lines = src.splitlines(keepends=True)
    spans = {}

    def doc_span(body):
        node = body[0] if body else None
        if (isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            return node.lineno, node.end_lineno
        return None

    if "__doc__" in names:
        spans["__doc__"] = doc_span(tree.body)

    def visit(body, prefix):
        for node in body:
            if not isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                continue
            q = prefix + node.name
            if q in names:
                start = min([node.lineno] + [d.lineno for d in node.decorator_list])
                spans[q] = (start, node.end_lineno)
                continue
            if isinstance(node, ast.ClassDef):
                if q + ".__doc__" in names:
                    spans[q + ".__doc__"] = doc_span(node.body)
                visit(node.body, q + ".")

    visit(tree.body, "")
    spans = {n: span for n, span in spans.items() if span is not None}
    cut = {n: "".join(lines[a - 1:b]) for n, (a, b) in spans.items()}
    drop = {i for a, b in spans.values() for i in range(a, b + 1)}
    rest = "".join(line for i, line in enumerate(lines, 1) if i not in drop)
    return rest, cut


@pytest.mark.parametrize("rel", sorted(COPIES))
def test_copied_module_equals_the_jax_one(rel):
    names = COPIES[rel]
    orig = open(os.path.join(ROOT, "bcg_tpu", rel), encoding="utf-8").read()
    port = open(os.path.join(ROOT, "bcg_tpu_torch", rel), encoding="utf-8").read()
    orig = _LINT_IGNORE.sub("", orig.replace("bcg_tpu.", "bcg_tpu_torch."))
    port = _LINT_IGNORE.sub("", port)
    orig_rest, orig_cut = _parts(orig, names)
    port_rest, port_cut = _parts(port, names)
    assert port_rest == orig_rest
    # Every named place exists on both sides and is where they differ.
    assert set(orig_cut) == set(port_cut) == set(names)
    for name in names:
        assert port_cut[name] != orig_cut[name], name


NEW_MODULES = sorted(COPIES) + ["api.py", "cli.py", "experiments.py", "engine/interface.py",
                                "engine/torch_engine.py"]


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_every_flag_the_modules_read_is_registered(rel):
    names = set()
    for pkg in ("bcg_tpu", "bcg_tpu_torch"):
        path = os.path.join(ROOT, pkg, rel)
        if os.path.exists(path):
            text = open(path, encoding="utf-8").read()
            names |= set(re.findall(r'(?:envflags\.)?(?:get_\w+|is_set)\(\s*"(BCG_TPU_\w+)"',
                                    text))
    missing = sorted(n for n in names if n not in envflags.REGISTRY)
    assert not missing


SLICE_FLAGS = [f"BCG_TPU_SERVE{s}" for s in (
    "", "_BUCKET_ROWS", "_DEADLINE_MS", "_DEFER_WAIT_S", "_LINGER_MS", "_MAX_DISPATCH_RETRIES",
    "_MAX_QUEUE_ROWS", "_SLO_MS", "_WATCHDOG_S")] + [
    f"BCG_TPU_SWEEP_{s}" for s in ("DIR", "MAX_CONCURRENT", "MAX_JOB_RETRIES",
                                   "TENANT_QUOTA_ROWS")] + [
    "BCG_TPU_COLLECTIVE_WATCHDOG_S", "BCG_TPU_FAULT_SEED"]


@pytest.mark.parametrize("name", SLICE_FLAGS)
def test_slice_flag_has_the_jax_packages_type_and_default(name):
    from bcg_tpu.runtime import envflags as j_envflags

    assert len(SLICE_FLAGS) == 15
    j, t = j_envflags.REGISTRY[name], envflags.REGISTRY[name]
    assert (t.kind, t.default) == (j.kind, j.default)


# ------------------------------------------------------- fake-engine games

def _fake_config(C, policy="consensus", fault_rate=0.0):
    return C.BCGConfig(engine=C.EngineConfig(backend="fake", fake_policy=policy,
                                             fault_rate=fault_rate, fault_seed=7))


def _fake_game(api, C, seed, policy="consensus", engine=None, rounds=4, fault_rate=0.0):
    return api.run_simulation(n_agents=5, byzantine_count=1, max_rounds=rounds, backend="fake",
                              seed=seed, engine=engine,
                              config=_fake_config(C, policy, fault_rate))["metrics"]


POLICIES = list(HONEST_POLICIES) + list(BYZANTINE_POLICIES) + ["mixed:consensus:disrupt",
                                                               "mixed:median:clique"]


@pytest.mark.parametrize("policy", POLICIES)
def test_fake_game_identical_in_both_packages(policy):
    j = _fake_game(j_api, jcfg, seed=2, policy=policy)
    t = _fake_game(t_api, tcfg, seed=2, policy=policy)
    assert t == j
    assert len(t) > 40 and t["total_rounds"] >= 1


def test_fault_injected_fake_game_identical_in_both_packages():
    j = _fake_game(j_api, jcfg, seed=1, rounds=5, fault_rate=0.3)
    t = _fake_game(t_api, tcfg, seed=1, rounds=5, fault_rate=0.3)
    assert t == j


def _four(api, C):
    return [lambda e, i=i: _fake_game(api, C, seed=i, engine=e, rounds=3 + i)
            for i in range(4)]


def _check_joined(prefix):
    """No worker or scheduler thread of a finished run is left behind."""
    deadline = time.monotonic() + JOIN_S
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate() if t.name.startswith(prefix)]
        if not left:
            return
        time.sleep(0.05)
    pytest.fail(f"threads still running: {[t.name for t in left]}")


@pytest.fixture(scope="module")
def fake_concurrent():
    out = {
        "j_coll": j_collective.run_concurrent_simulations(JFakeEngine(seed=0),
                                                          _four(j_api, jcfg), 4),
        "t_coll": t_collective.run_concurrent_simulations(TFakeEngine(seed=0),
                                                          _four(t_api, tcfg), 4),
        "j_serve": j_serve.run_serving_simulations(JFakeEngine(seed=0), _four(j_api, jcfg),
                                                   linger_ms=2),
        "t_serve": t_serve.run_serving_simulations(TFakeEngine(seed=0), _four(t_api, tcfg),
                                                   linger_ms=2),
    }
    _check_joined("bcg-")
    for results in out.values():
        for r in results:
            if isinstance(r, BaseException):
                raise r
    return out


@pytest.mark.parametrize("proxy", ["coll", "serve"])
def test_four_concurrent_fake_games_identical_in_both_packages(fake_concurrent, proxy):
    assert fake_concurrent[f"t_{proxy}"] == fake_concurrent[f"j_{proxy}"]
    assert [m["total_rounds"] >= 1 for m in fake_concurrent[f"t_{proxy}"]] == [True] * 4


def test_serving_matches_collective_results(fake_concurrent):
    assert fake_concurrent["t_serve"] == fake_concurrent["t_coll"]


# ------------------------------------------------------ real-engine games

# Short budgets keep the tiny games to a fraction of a second a call; the
# guided grammar closes every row within them.
LLM = dict(temperature_decide=0.0, temperature_vote=0.0, max_tokens_decide=96,
           max_tokens_vote=48)


def _config(C, backend, seed, rounds=2):
    return C.BCGConfig(
        game=C.GameConfig(num_honest=2, num_byzantine=1, max_rounds=rounds, seed=seed),
        engine=C.EngineConfig(backend=backend, model_name=MODEL, max_model_len=2048),
        llm=C.LLMConfig(**LLM),
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


def _play(Sim, cfg, engine):
    """One game on ``engine``: (decisions by round, votes by round,
    statistics)."""
    sim = Sim(cfg, engine=engine)
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    decisions = [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds]
    return decisions, votes, stats


def _results(outs):
    for o in outs:
        if isinstance(o, BaseException):
            raise o
    return outs


SEEDS = (3, 4)


@pytest.fixture(scope="module")
def torch_engine(weights):
    eng = TorchEngine(_config(tcfg, "torch", 0).engine, device="cpu", params=weights[1])
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def concurrent_real(weights, torch_engine):
    jp, _ = weights
    jeng = JaxEngine(_config(jcfg, "jax", 0).engine, params=jp)
    try:
        j = _results(j_collective.run_concurrent_simulations(
            jeng, [lambda e, s=s: _play(JSimulation, _config(jcfg, "jax", s), e)
                   for s in SEEDS], 2))
    finally:
        jeng.shutdown()
    t = _results(t_collective.run_concurrent_simulations(
        torch_engine, [lambda e, s=s: _play(TSimulation, _config(tcfg, "torch", s), e)
                       for s in SEEDS], 2))
    _check_joined("bcg-")
    return j, t


@pytest.mark.parametrize("game", range(len(SEEDS)))
def test_concurrent_greedy_games_identical_on_jax_and_torch(concurrent_real, game):
    j, t = concurrent_real
    (jdec, jvotes, jstats), (tdec, tvotes, tstats) = j[game], t[game]
    assert tdec == jdec
    assert tvotes == jvotes
    assert tstats == jstats
    assert len(tstats) > 40 and tstats["total_rounds"] >= 1


class _Recorder:
    """Engine proxy that records every guided call's rows, settings, raw
    texts (the engine's ``_run_guided`` output) and wall seconds."""

    def __init__(self, engine):
        self.engine = engine
        self.calls = []

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        texts = []
        run = self.engine._run_guided

        def capture(*args, **kwargs):
            out = run(*args, **kwargs)
            texts.extend(out)
            return out

        self.engine._run_guided = capture
        t0 = time.perf_counter()
        try:
            out = self.engine.batch_generate_json(prompts, temperature, max_tokens)
        finally:
            del self.engine._run_guided
        self.calls.append((list(prompts), temperature, max_tokens, texts,
                           time.perf_counter() - t0))
        return out

    def __getattr__(self, name):
        return getattr(self.engine, name)


def _rows(value, n):
    return list(value) if isinstance(value, (list, tuple)) else [value] * n


SOLO_SEEDS = SEEDS + (5,)


@pytest.fixture(scope="module")
def solo(torch_engine):
    """Each game of ``SOLO_SEEDS`` alone on the engine: its result and
    its recorded calls."""
    out = {}
    for seed in SOLO_SEEDS:
        rec = _Recorder(torch_engine)
        out[seed] = (_play(TSimulation, _config(tcfg, "torch", seed), rec), rec.calls)
    return out


def test_rows_token_identical_alone_and_merged(torch_engine, solo):
    """Each of game A's calls again, merged after game B's rows of the
    same phase: A's rows decode to the same tokens as alone."""
    (_, a), (_, b) = solo[SEEDS[0]], solo[SEEDS[1]]
    assert a and len(a) == len(b)
    for (pa, ta, ma, texts_a, _), (pb, tb, mb, _, _) in zip(a, b):
        merged = _Recorder(torch_engine)
        merged.batch_generate_json(pb + pa, _rows(tb, len(pb)) + _rows(ta, len(pa)),
                                   _rows(mb, len(pb)) + _rows(ma, len(pa)))
        texts = merged.calls[0][3]
        assert len(texts) == len(pb) + len(pa)
        assert texts[len(pb):] == texts_a


def test_served_greedy_games_equal_their_solo_runs(torch_engine, solo):
    seeds = SOLO_SEEDS
    serving = ServingEngine(torch_engine, linger_ms=50)
    try:
        served = _results(t_serve.run_serving_simulations(
            torch_engine, [lambda e, s=s: _play(TSimulation, _config(tcfg, "torch", s), e)
                           for s in seeds], serving=serving))
        stats = serving.stats()
    finally:
        serving.scheduler.close(timeout=JOIN_S)
    _check_joined("bcg-serve")
    assert served == [solo[s][0] for s in seeds]
    assert stats["completed"] > 0 and stats["failed"] == 0
    assert stats["merged_dispatches"] >= 1
    assert torch_engine.failed_rows == 0


def test_row_cap_bounds_merged_dispatches_under_a_tight_limit(weights):
    eng = TorchEngine(_config(tcfg, "torch", 0).engine, device="cpu", params=weights[1])
    try:
        assert derive_row_cap(eng) is None          # no device limit on the CPU
        window = eng.worst_case_decode_window()
        per_row = window * eng._kv_slot_bytes * eng.spec.num_layers
        reserve = eng._prefix_budget
        # Room for 4.5 rows at the worst window: two 3-row games never merge.
        eng._mem_limit = int((eng._param_bytes + reserve + 4.5 * per_row)
                             / eng.config.hbm_utilization)
        assert derive_row_cap(eng) == eng.cap_for(window) == 4
        dispatched = []
        call = eng.batch_generate_json

        def counted(prompts, temperature=0.8, max_tokens=512):
            dispatched.append(len(prompts))
            return call(prompts, temperature, max_tokens)

        eng.batch_generate_json = counted
        serving = ServingEngine(eng, linger_ms=200)
        try:
            assert serving.scheduler.row_cap == 4
            served = _results(t_serve.run_serving_simulations(
                eng, [lambda e, s=s: _play(TSimulation, _config(tcfg, "torch", s, rounds=1), e)
                      for s in SEEDS], serving=serving))
            stats = serving.stats()
        finally:
            serving.scheduler.close(timeout=JOIN_S)
        _check_joined("bcg-serve")
        assert all(s["total_rounds"] == 1 for _, _, s in served)
        assert dispatched and max(dispatched) <= 4
        assert stats["row_cap"] == 4 and stats["merged_dispatches"] == 0
    finally:
        eng.shutdown()


def test_supervisor_rebuilds_a_hung_engine_once(weights, solo, monkeypatch):
    """``hang@serve.dispatch:1`` past a watchdog of three times the
    longest solo call: the supervisor builds a fresh engine over the
    shared weights and the dispatch is retried on it (a cold call, its
    prefixes built anew, which the watchdog also bounds); the condemned
    call wakes once the games are over, on its abandoned thread, and is
    joined.  A call of the tiny model takes seconds on the CPU (the plain
    prefill attention), so the watchdog is seconds too."""
    _, tp = weights
    cfg = _config(tcfg, "torch", 3, rounds=1)
    eng = TorchEngine(cfg.engine, device="cpu", params=tp)
    longest = max(c[4] for _, calls in solo.values() for c in calls)
    watchdog = max(0.5, 3.0 * longest)
    built = []

    def factory():
        fresh = TorchEngine(cfg.engine, device="cpu", params=tp)
        built.append(fresh)
        return fresh

    hang = watchdog + 3.0 * longest + 2.0
    monkeypatch.setenv("BCG_TPU_CHAOS", f"hang@serve.dispatch:1:{hang:.2f}")
    resilience.reset()
    serving = ServingEngine(eng, engine_factory=factory, watchdog_s=watchdog, linger_ms=50)
    try:
        served = _results(t_serve.run_serving_simulations(
            eng, [lambda e, s=s: _play(TSimulation, _config(tcfg, "torch", s, rounds=1), e)
                  for s in SEEDS], serving=serving))
        stats = serving.stats()
    finally:
        serving.scheduler.close(timeout=JOIN_S)
        monkeypatch.delenv("BCG_TPU_CHAOS")
        resilience.reset()
    _check_joined("bcg-serve")                      # the condemned worker included
    assert len(built) == 1
    assert stats["recovery"]["engine_rebuilds"] == 1
    assert stats["failed"] == 0
    assert all(s["total_rounds"] == 1 for _, _, s in served)
    assert built[0].failed_rows == 0
    eng.shutdown()
    built[0].shutdown()


# ------------------------------------------------------------ entry points

class _Seen:
    """Wraps ``create_engine`` to keep what it built."""

    def __init__(self, monkeypatch):
        from bcg_tpu_torch.engine import interface

        self.built = []
        real = interface.create_engine

        def create(cfg, llm_config=None, device=None):
            eng = real(cfg, llm_config, device=device)
            self.built.append(eng)
            return eng

        monkeypatch.setattr(interface, "create_engine", create)


def test_run_simulation_builds_a_torch_engine_with_no_backend_named(monkeypatch):
    seen = _Seen(monkeypatch)
    out = t_api.run_simulation(n_agents=3, byzantine_count=1, max_rounds=1, model_name=MODEL,
                               seed=3, device="cpu",
                               config=tcfg.BCGConfig(llm=tcfg.LLMConfig(**LLM)))
    assert tcfg.EngineConfig().backend == "torch"
    assert [type(e) for e in seen.built] == [TorchEngine]
    assert seen.built[0].device.type == "cpu"
    assert out["metrics"]["total_rounds"] == 1


def test_serve_flag_wraps_the_created_engine(monkeypatch):
    from bcg_tpu_torch.runtime import metrics

    monkeypatch.setenv("BCG_TPU_SERVE", "1")
    metrics.publish_serve_stats(None)
    seen = _Seen(monkeypatch)
    wrapped = []
    real_init = ServingEngine.__init__

    def init(self, engine, **kw):
        wrapped.append((engine, kw))
        real_init(self, engine, **kw)

    monkeypatch.setattr(ServingEngine, "__init__", init)
    out = t_api.run_simulation(n_agents=3, byzantine_count=1, max_rounds=1, model_name=MODEL,
                               seed=3, device="cpu",
                               config=tcfg.BCGConfig(llm=tcfg.LLMConfig(**LLM)))
    _check_joined("bcg-serve")
    assert out["metrics"]["total_rounds"] == 1
    assert len(wrapped) == 1 and wrapped[0][0] is seen.built[0]
    assert isinstance(seen.built[0], TorchEngine)
    assert wrapped[0][1]["owns_inner"] is True and callable(wrapped[0][1]["engine_factory"])
    assert metrics.LAST_SERVE_STATS is not None and metrics.LAST_SERVE_STATS["completed"] > 0


@pytest.mark.parametrize("serve", [False, True])
def test_run_preset_runs_concurrent_games_on_the_cpu(monkeypatch, serve):
    from bcg_tpu_torch.experiments import PRESETS, run_preset

    if serve:
        monkeypatch.setenv("BCG_TPU_SERVE", "1")
    # The preset's games with the short budgets (run_preset starts from
    # the default BCGConfig).
    monkeypatch.setattr(tcfg, "BCGConfig", lambda C=tcfg.BCGConfig, **kw: C(
        **{"llm": tcfg.LLMConfig(**LLM), **kw}))
    seen = _Seen(monkeypatch)
    out = run_preset(PRESETS["q2"], runs=2, model_name=MODEL, max_rounds=1, seed=0,
                     honest=2, byzantine=1, concurrency=2, device="cpu")
    _check_joined("bcg-")
    assert len(out["per_run"]) == 2
    assert all(m["total_rounds"] == 1 for m in out["per_run"])
    assert [type(e) for e in seen.built] == [TorchEngine]


def test_create_engine_builds_fake_and_fault_injecting_engines(monkeypatch):
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine import create_engine
    from bcg_tpu_torch.engine.fault import FaultInjectingEngine

    fake = create_engine(EngineConfig(backend="fake", fake_policy="stubborn", fake_seed=4))
    assert isinstance(fake, TFakeEngine) and fake.policy == "stubborn" and fake.seed == 4
    wrapped = create_engine(EngineConfig(backend="fake", fault_rate=0.25, fault_seed=9))
    assert isinstance(wrapped, FaultInjectingEngine) and wrapped.rate == 0.25
    assert isinstance(wrapped._engine, TFakeEngine)
    monkeypatch.setenv("BCG_TPU_FAULT_RATE", "0.5")
    monkeypatch.setenv("BCG_TPU_FAULT_SEED", "11")
    env = create_engine(EngineConfig(backend="fake"))
    assert isinstance(env, FaultInjectingEngine) and env.rate == 0.5
    assert env.rng.random() == random.Random(11).random()
    monkeypatch.delenv("BCG_TPU_FAULT_SEED")

    def no_boot(*a, **k):
        raise AssertionError("an engine booted before the fault rate was checked")

    monkeypatch.setattr(TorchEngine, "__init__", no_boot)
    for raw in ("1.5", "-0.1"):
        monkeypatch.setenv("BCG_TPU_FAULT_RATE", raw)
        with pytest.raises(ValueError, match="outside"):
            create_engine(EngineConfig(model_name=MODEL), device="cpu")
    monkeypatch.delenv("BCG_TPU_FAULT_RATE")
    with pytest.raises(ValueError, match="outside"):
        create_engine(EngineConfig(model_name=MODEL, fault_rate=2.0), device="cpu")

