"""Rank bodies of the port's parallel tests (not a pytest module).

Each function runs on every rank of a world that
``bcg_tpu_torch.parallel.distributed.spawn_world`` starts for one test
module; it reads the module's inputs (``.npz`` + ``.json`` written by the
pytest process from numpy seeds), runs all of the module's cases and
writes this rank's results as ``<out>/rank<r>.npz``.  It imports torch and
the port, never JAX.
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from bcg_tpu_torch.parallel.collectives import axis_rank, axis_size


def _save(out, results):
    np.savez(os.path.join(out, f"rank{dist.get_rank()}.npz"), **results)


def _mesh(tp=1, sp=1):
    from bcg_tpu_torch.parallel.distributed import build_hybrid_mesh

    return build_hybrid_mesh(tp=tp, sp=sp)


def _block(x, mesh, axis, dim):
    n = x.shape[dim] // axis_size(mesh, axis)
    return x.narrow(dim, axis_rank(mesh, axis) * n, n)


# ------------------------------------------------------------ ring attention

def ring_cases(inputs, out, tp=1, sp=2):
    """Every case of ``inputs`` on this rank's shard: its block of the
    sequence over ``sp`` and of the heads over ``tp``."""
    from bcg_tpu_torch.ops import ring_attention as ra
    from bcg_tpu_torch.ops.decode_attention import quantize_kv

    mesh = _mesh(tp=tp, sp=sp)
    data = np.load(inputs + ".npz")
    with open(inputs + ".json") as f:
        cases = json.load(f)
    res = {"coords": np.array([axis_rank(mesh, "tp"), axis_rank(mesh, "sp")])}
    for c in cases:
        name = c["name"]
        dt = torch.bfloat16 if c["dtype"] == "bf16" else torch.float32
        a = {k.split("/", 1)[1]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith(name + "/")}
        if c["fn"] == "indivisible":
            try:
                ra.shard_seq(a["x"], mesh)
                res[name] = np.array(0)
            except ValueError:
                res[name] = np.array(1)
            continue
        q, k, v = (a[n].to(dt) for n in ("q", "k", "v"))
        if c["fn"] == "ring":
            qb, kb, vb = (_block(_block(t, mesh, "sp", 1), mesh, "tp", 2) for t in (q, k, v))
            valid = _block(a["valid"], mesh, "sp", 1) if "valid" in a else None
            o = ra.ring_attention(qb, kb, vb, mesh, causal=c["causal"], kv_valid=valid)
        else:
            head_dim = 1 if c["fn"] == "decode" else 2
            qb = _block(q, mesh, "tp", head_dim)
            mask = _block(a["mask"], mesh, "sp", a["mask"].dim() - 1)
            kw = {}
            if c.get("int8"):
                # The engine's int8 layout [B, Hkv, S, Dh] + scales [B, Hkv, S].
                kq8, ks = quantize_kv(k.transpose(1, 2))
                vq8, vs = quantize_kv(v.transpose(1, 2))
                kb, vb = (_block(_block(t, mesh, "sp", 2), mesh, "tp", 1) for t in (kq8, vq8))
                kw = dict(k_scale=_block(_block(ks, mesh, "sp", 2), mesh, "tp", 1),
                          v_scale=_block(_block(vs, mesh, "sp", 2), mesh, "tp", 1))
            else:
                kb, vb = (_block(_block(t, mesh, "sp", 1), mesh, "tp", 2) for t in (k, v))
            fn = ra.sp_decode_attention if c["fn"] == "decode" else ra.sp_chunk_decode_attention
            o = fn(qb, kb, vb, mask, mesh, **kw)
        res[name] = o.float().numpy()
    _save(out, res)


# ------------------------------------------------------------ game step

def game_step_cases(inputs, out):
    """The SPMD game-step forms on this rank's agents over a dp world."""
    from bcg_tpu_torch.parallel import game_step as gs

    mesh = _mesh()
    data = np.load(inputs + ".npz")
    with open(inputs + ".json") as f:
        cases = json.load(f)
    res = {}
    for c in cases:
        name = c["name"]
        a = {k.split("/", 1)[1]: torch.from_numpy(data[k]) for k in data.files
             if k.startswith(name + "/")}
        n = a["mask"].shape[0]
        if c.get("indivisible"):
            try:
                gs.shard_agents(n, mesh)
                res[name] = np.array(0)
            except ValueError:
                res[name] = np.array(1)
            continue
        rows = gs.shard_agents(n, mesh)
        mask = a["mask"][rows]
        res[name + "/received"] = gs.exchange_values(a["values"][rows], mask, mesh).numpy()
        res[name + "/matrix"] = gs.exchange_proposals(a["matrix"][:, rows], mask, mesh).numpy()
        tally = gs.tally_votes(a["votes"][rows], mesh)
        res[name + "/tally"] = np.array([int(tally[k]) for k in
                                         ("stop", "continue", "abstain", "terminate",
                                          "half_stop")])
        cons = gs.check_consensus_spmd(a["values"][rows], a["byz"][rows], a["inits"][rows],
                                       mesh)
        res[name + "/consensus"] = np.array([float(cons["has_consensus"]),
                                             float(cons["consensus_value"]),
                                             float(cons["agreement_pct"])])
        received, tally2, cons2 = gs.spmd_round_arrays(a["values"][rows], a["votes"][rows], mask,
                                                       a["byz"][rows], a["inits"][rows], mesh)
        res[name + "/round_received"] = received.numpy()
        res[name + "/round_stop"] = np.array(int(tally2["stop"]))
        res[name + "/round_consensus"] = np.array(bool(cons2["has_consensus"]))
    _save(out, res)


# ------------------------------------------------------------ runtime

def runtime_cases(out):
    """``initialize``'s world, ``process_info``, the hybrid mesh's refusal
    of a tp group across hosts, the collectives' staging rule and
    ``shutdown``."""
    from bcg_tpu_torch.obs import counters, fleet
    from bcg_tpu_torch.parallel import collectives, distributed
    from bcg_tpu_torch.parallel.mesh import mesh_shape

    info = distributed.process_info()
    res = {"info": np.array([info["process_index"], info["process_count"],
                             info["local_device_count"], info["global_device_count"]]),
           "backend": np.array(info["backend"]),
           "fleet": np.array([fleet.process_index(), fleet.process_count()])}
    world = info["process_count"]
    mesh = distributed.build_hybrid_mesh(tp=2, sp=1)
    res["mesh"] = np.array([mesh_shape(mesh)[a] for a in ("dp", "tp", "sp")])
    res["spans"] = np.array(distributed.mesh_spans_processes(mesh))
    # Hosts of one rank each (as LOCAL_WORLD_SIZE says in a world of one
    # rank a host) cannot hold a tp group of 2.
    distributed._state["local_world"] = 1
    try:
        distributed.build_hybrid_mesh(tp=2, sp=1)
        res["refused"] = np.array(0)
    except ValueError as e:
        res["refused"] = np.array(1 if "does not pack" in str(e) else 2)
    distributed._state["local_world"] = world
    before = counters.value("engine.collective.all_gather")
    t = torch.full((2,), float(dist.get_rank()))
    res["gather"] = collectives.all_gather(t, mesh, "tp").numpy()
    res["reduce_max"] = collectives.all_reduce(t.clone(), mesh, "tp", op="max").numpy()
    res["shift"] = collectives.ring_shift([t], mesh, "tp")[0].numpy()
    res["counted"] = np.array([counters.value("engine.collective.all_gather") - before,
                               counters.value("engine.collective.staged")])
    res["single"] = collectives.all_gather(t, None, "tp").numpy()
    # A mesh engine runs on its rank's device, and a device left unnamed
    # means CUDA: without a card it raises, as the one-rank engine does.
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    try:
        TorchEngine(EngineConfig(backend="torch", model_name="bcg-tpu/tiny-test"), mesh=mesh)
        res["unnamed_device"] = np.array("")
    except RuntimeError as e:
        res["unnamed_device"] = np.array(str(e))
    _save(out, res)
    distributed.shutdown()
    res_after = np.array([dist.is_initialized(), distributed.world_size()])
    np.save(os.path.join(out, f"after{info['process_index']}.npy"), res_after)


def hang(seconds):
    """A rank that never finishes in time (the wall limit's test)."""
    time.sleep(seconds)


def fail_on_rank(rank):
    """One rank raises; the other waits on a collective it never gets."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    time.sleep(60)


# ------------------------------------------------------------ engine

def _record(module, names, log):
    """Wrap ``module``'s functions ``names`` so each call's logits land in
    ``log`` (a list of ``(name, array)``); returns the originals."""
    saved = {n: getattr(module, n) for n in names}
    for n, fn in saved.items():
        def wrapped(*a, _fn=fn, _n=n, **k):
            logits, cache = _fn(*a, **k)
            log.append((_n, logits.float().numpy().copy()))
            return logits, cache
        setattr(module, n, wrapped)
    return saved


def engine_cases(inputs, out):
    """Each arm of ``inputs.json`` (a model and mesh sizes over this
    world): the sharded model's prefill and decode-step logits on fixed
    tokens, the engine's greedy ``batch_generate_json`` with every prefill
    and decode step's logits recorded, and (where the arm asks) a greedy
    8H+2B game — its statistics, decisions and votes."""
    from bcg_tpu_torch import config as tcfg
    from bcg_tpu_torch.engine import torch_engine as te
    from bcg_tpu_torch.models import transformer as T
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import params_from_numpy
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    with open(inputs + ".json") as f:
        spec_all = json.load(f)
    res = {}
    for arm in spec_all["arms"]:
        name, model = arm["name"], arm["model"]
        data = np.load(f"{inputs}_{model.split('/')[-1]}.npz")
        params = params_from_numpy([(k, data[k]) for k in data.files], spec_for_model(model),
                                   "cpu", torch.float32)
        sizes = dict(tensor_parallel_size=arm["tp"], sequence_parallel_size=arm["sp"],
                     data_parallel_size=arm["dp"])
        engine = te.TorchEngine(tcfg.EngineConfig(backend="torch", model_name=model,
                                                  max_model_len=2048, **sizes),
                                device="cpu", params=params)
        spec, mesh = engine.spec, engine.mesh
        # Model level: fixed tokens through the sharded model.
        fixed = np.load(inputs + "_tokens.npz")
        tok, valid = torch.from_numpy(fixed["tokens"]).long(), torch.from_numpy(fixed["valid"])
        B, L = tok.shape
        cache = T.init_kv_cache(spec, B, L + 4, torch.bfloat16, seq_split=True)
        fn = T.prefill_sp if arm["sp"] > 1 else T.prefill
        rows = slice(None)
        if arm["dp"] > 1:
            n = B // arm["dp"]
            rows = slice(spec.par.dp_rank * n, (spec.par.dp_rank + 1) * n)
            cache = T.init_kv_cache(spec, n, L + 4, torch.bfloat16, seq_split=True)
        logits, cache = fn(engine.params, spec, tok[rows], valid[rows], cache)
        res[f"{name}/model_prefill"] = logits.numpy()
        vm = torch.zeros(B, L + 4, dtype=torch.bool)
        vm[:, :L] = valid
        vm[:, L] = True
        step, _ = T.decode_step(engine.params, spec, torch.arange(B)[rows] + 3, L,
                                valid.sum(1).int()[rows], cache, vm[rows])
        res[f"{name}/model_decode"] = step.numpy()
        # Engine level.
        log = []
        saved = _record(te, ("prefill", "prefill_sp", "prefill_with_prefix", "prefill_chunk_at",
                             "decode_step"), log)
        try:
            results = engine.batch_generate_json(
                [tuple(p) for p in spec_all["prompts"]], temperature=0.0, max_tokens=64)
        finally:
            for n_, f_ in saved.items():
                setattr(te, n_, f_)
        res[f"{name}/results"] = np.array(json.dumps(results))
        res[f"{name}/calls"] = np.array(json.dumps([n_ for n_, _ in log]))
        for i, (_, arr) in enumerate(log):
            res[f"{name}/call{i}"] = arr
        if arm.get("game"):
            cfg = tcfg.BCGConfig(
                game=tcfg.GameConfig(num_honest=8, num_byzantine=2, max_rounds=1, seed=3),
                network=tcfg.NetworkConfig(spmd_exchange=arm["dp"] > 1),
                engine=engine.config,
                llm=tcfg.LLMConfig(temperature_decide=0.0, temperature_vote=0.0),
                metrics=tcfg.MetricsConfig(save_results=False),
            )
            sim = BCGSimulation(cfg, engine=engine)
            votes = []
            close = sim._advance_and_record

            def record(round_num, agent_votes, _close=close, _votes=votes):
                _votes.append([round_num, dict(agent_votes)])
                return _close(round_num, agent_votes)

            sim._advance_and_record = record
            stats = sim.run()
            decisions = [[r.round_num, dict(r.agent_values)] for r in sim.game.rounds]
            res[f"{name}/game"] = np.array(json.dumps(
                dict(stats=stats, decisions=decisions, votes=votes,
                     reason=sim.game.termination_reason, failed=engine.failed_rows),
                sort_keys=True, default=str))
            sim.close()
        engine.shutdown()
    _save(out, res)


# ------------------------------------------------------------ engine knobs

def pool_digest(engine):
    """A digest of a paged engine's pool contents (every layer's blocks)."""
    import hashlib

    h = hashlib.sha256()
    for entry in engine._paged.pool:
        for name in sorted(entry):
            h.update(entry[name].contiguous().view(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def knob_cases(inputs, out):
    """Each arm of ``inputs.json`` (a model, its engine knobs and mesh
    sizes over this world): the JAX initializer's weights (f32), then one
    greedy ``batch_generate_json`` a round of ``rounds`` (each round's
    prompts extend the last's); per round the results and, for a paged
    engine, its pool statistics and a digest of its pool's contents."""
    from bcg_tpu_torch import config as tcfg
    from bcg_tpu_torch.engine import torch_engine as te
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import params_from_numpy

    with open(inputs + ".json") as f:
        spec_all = json.load(f)
    res = {}
    for arm in spec_all["arms"]:
        name, model = arm["name"], arm["model"]
        data = np.load(f"{inputs}_{model.split('/')[-1]}.npz")
        params = params_from_numpy([(k, data[k]) for k in data.files], spec_for_model(model),
                                   "cpu", torch.float32)
        engine = te.TorchEngine(tcfg.EngineConfig(backend="torch", model_name=model,
                                                  max_model_len=2048, **arm["kw"]),
                                device="cpu", params=params)
        for i, prompts in enumerate(spec_all["rounds"][:arm.get("rounds", 1)]):
            results = engine.batch_generate_json([tuple(p) for p in prompts], temperature=0.0,
                                                 max_tokens=spec_all["max_tokens"])
            res[f"{name}/r{i}"] = np.array(json.dumps(results))
            pool = engine.kv_pool_stats()
            if pool is not None:
                res[f"{name}/pool{i}"] = np.array(json.dumps(
                    {k: pool[k] for k in ("blocks_free", "blocks_resident",
                                          "prefix_hit_rate")}))
                res[f"{name}/digest{i}"] = np.array(pool_digest(engine))
        res[f"{name}/failed"] = np.array(engine.failed_rows)
        engine.shutdown()
    _save(out, res)


# ------------------------------------------------------------ serving

def serve_cases(inputs, out):
    """Each arm of ``inputs.json``: an engine of the arm's mesh sizes over
    the JAX initializer's weights; rank 0 plays the arm's greedy games
    behind ``ServingEngine`` (its leader recording every dispatch), every
    other rank follows them (``serve.mesh.follow``), under the arm's
    ``chaos`` (``BCG_TPU_CHAOS``) and watchdog.  Per arm: the games, the
    scheduler's statistics and each rank's outputs by dispatch."""
    from bcg_tpu_torch import config as tcfg
    from bcg_tpu_torch.engine import torch_engine as te
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import params_from_numpy
    from bcg_tpu_torch.runtime import resilience
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation
    from bcg_tpu_torch.serve import ServingEngine, mesh as mesh_serving, run_serving_simulations

    with open(inputs + ".json") as f:
        spec_all = json.load(f)
    model = spec_all["model"]
    data = np.load(f"{inputs}_{model.split('/')[-1]}.npz")
    params = params_from_numpy([(k, data[k]) for k in data.files], spec_for_model(model),
                               "cpu", torch.float32)
    res = {}
    for arm in spec_all["arms"]:
        name = arm["name"]
        ecfg = tcfg.EngineConfig(backend="torch", model_name=model, max_model_len=2048,
                                 **arm["kw"])
        built = []

        def factory(ecfg=ecfg, built=built):
            fresh = te.TorchEngine(ecfg, device="cpu", params=params)
            built.append(fresh)
            return fresh

        engine = te.TorchEngine(ecfg, device="cpu", params=params)
        if arm.get("chaos"):
            os.environ["BCG_TPU_CHAOS"] = arm["chaos"]
        resilience.reset()
        try:
            if dist.get_rank() != 0:
                outs = mesh_serving.follow(engine, factory, record=True)
            else:
                def game(seed):
                    def run(served):
                        cfg = tcfg.BCGConfig(
                            game=tcfg.GameConfig(num_honest=2, num_byzantine=1,
                                                 max_rounds=1, seed=seed),
                            engine=ecfg, llm=tcfg.LLMConfig(**spec_all["llm"]),
                            metrics=tcfg.MetricsConfig(save_results=False))
                        sim = BCGSimulation(cfg, engine=served)
                        stats = sim.run()
                        decisions = [[r.round_num, dict(r.agent_values)]
                                     for r in sim.game.rounds]
                        sim.close()
                        return dict(stats=stats, decisions=decisions)
                    return run

                serving = ServingEngine(engine, engine_factory=factory,
                                        watchdog_s=arm.get("watchdog_s", 0),
                                        max_dispatch_retries=arm.get("retries", 0),
                                        linger_ms=arm.get("linger_ms", 50))
                serving.leader.record = True
                games = run_serving_simulations(engine, [game(s) for s in spec_all["seeds"]],
                                                serving=serving)
                stats = serving.stats()
                serving.shutdown()
                res[f"{name}/games"] = np.array(json.dumps(
                    [g if isinstance(g, dict) else repr(g) for g in games],
                    sort_keys=True, default=str))
                res[f"{name}/stats"] = np.array(json.dumps(
                    {k: stats.get(k) for k in ("dispatches", "merged_dispatches", "failed",
                                               "completed", "recovery")}, default=str))
                outs = [d["out"] for d in serving.leader.log]
        finally:
            os.environ.pop("BCG_TPU_CHAOS", None)
            resilience.reset()
        res[f"{name}/outputs"] = np.array(json.dumps(outs, default=repr))
        res[f"{name}/rebuilt"] = np.array(len(built))
        res[f"{name}/failed"] = np.array(sum(e.failed_rows for e in [engine] + built))
        for e in [engine] + built:
            e.shutdown()
    _save(out, res)


# ------------------------------------------------------------ row-parallel products

def row_parallel_cases(inputs, out):
    """``quantize.dense_row_parallel`` on this rank's tp slice of each
    case's activation and weight (the weight quantized whole, then sliced
    by ``parallel.sharding.shard_leaf``), beside the one-device
    ``dense`` of the whole weight."""
    from bcg_tpu_torch.models.configs import DenseRoute, spec_for_model
    from bcg_tpu_torch.models.quantize import dense, dense_row_parallel, weight_quantizer
    from bcg_tpu_torch.parallel.sharding import shard_leaf

    mesh = _mesh(tp=2)
    data = np.load(inputs + ".npz")
    spec = spec_for_model("bcg-tpu/tiny-dh128")
    res = {}
    for mode in ("int8", "int4"):
        for route in (DenseRoute(), DenseRoute(w8a16_rows=4)):
            x, w = torch.from_numpy(data["x"]), torch.from_numpy(data["w"])
            full = weight_quantizer(mode)(w)
            local = shard_leaf("layers.0.w_down", full, spec, mesh, tuple(w.shape))
            xs = _block(x, mesh, "tp", x.dim() - 1)
            key = f"{mode}_{route.w8a16_rows}"
            res[key + "/mesh"] = dense_row_parallel(xs, local, mesh, route=route).numpy()
            res[key + "/one"] = dense(x, full, torch.float32, route=route).numpy()
    _save(out, res)
