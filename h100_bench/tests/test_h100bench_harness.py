"""The harness at a tiny size on the CPU: finding a cell's parts by
name, whole runs of the tiny cells, the faults that must turn
``correct`` false, the refusal on a machine with no card, and the
imports of a run.  ``test_control_on_card`` needs the card."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from h100_bench import run
from h100_bench.registry import Registry

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
DATA = os.path.join(HERE, "data")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def _tiny_bench(tmp_path, extra=()):
    bench = {
        "workloads": [
            {"name": "tiny.serve", "config": "tiny-dh128-bf16", "traffic": "tiny-serve", "chips": 1},
            {"name": "tiny4.serve", "config": "tiny-dh128-w4a16", "traffic": "tiny-serve",
             "chips": 1},
            *extra],
        "configs": [{"name": "tiny-dh128-bf16"}, {"name": "tiny-dh128-w4a16"}],
        "end_to_end": BENCH["end_to_end"], "per_layer": BENCH["per_layer"]}
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return str(path)


# ------------------------------------------------------------ by name

@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(name):
    reg = Registry()
    cell = reg.cell(name)
    assert cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"decisions_per_s", "peak_mem_gb", "setup_s"}
    mods = reg.metrics(cell.end_to_end + cell.per_layer)
    for m in cell.per_layer:
        assert mods[m["name"]].LAYER == m["layer"] and mods[m["name"]].MOVES == m["moves"]
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_new_parts_are_new_files_only(tmp_path):
    """A new configuration, traffic mix and per-layer metric, added as
    files and entries, are found with no edit to an existing file."""
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.load(open(os.path.join(ROOT, "h100_bench", "configs", "qwen3-8b-w4a16.json")))
    cfg["name"] = "new-model"
    (tmp_path / "configs" / "new-model.json").write_text(json.dumps(cfg))
    trf = json.load(open(os.path.join(ROOT, "h100_bench", "traffic", "serve-g3.json")))
    trf["games"] = 1
    (tmp_path / "traffic" / "solo.json").write_text(json.dumps(trf))
    (tmp_path / "metrics" / "new_metric.py").write_text(
        'UNIT = "x"\nBETTER = "higher"\nSOURCE = "program_counter"\nLAYER = "l"\n'
        'MOVES = "decisions_per_s"\n\ndef read(run):\n    return 1.0\n')
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{"name": "new-model"}]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "new-model.solo", "config": "new-model", "traffic": "solo", "chips": 1}]
    bench["per_layer"] = BENCH["per_layer"] + [
        {"name": "new_metric", "unit": "x", "better": "higher", "source": "program_counter",
         "layer": "l", "moves": "decisions_per_s", "workloads": ["new-model.solo"]}]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    reg = Registry(str(path), [str(tmp_path)])
    cell = reg.cell("new-model.solo")
    assert cell.traffic["games"] == 1 and cell.config["name"] == "new-model"
    assert "new_metric" in reg.metrics(cell.per_layer)
    assert "new_metric" not in {m["name"] for m in reg.cell(BENCH["workloads"][0]["name"]).per_layer}


def test_unit_mismatch_is_refused(tmp_path):
    bench = dict(BENCH)
    bench["end_to_end"] = [dict(BENCH["end_to_end"][0], unit="decisions per s")]
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    reg = Registry(str(path))
    with pytest.raises(ValueError):
        reg.metrics(reg.cell(BENCH["workloads"][0]["name"]).end_to_end)


# ------------------------------------------------------- tiny CPU runs

def _run(tmp_path, cell, seed=20241018001, after_boot=None, control=False):
    reg = Registry(_tiny_bench(tmp_path), [DATA])
    return run.execute(reg.cell(cell), seed, 0.5, False, "cpu", t_start=time.perf_counter(),
                       registry=reg, after_boot=after_boot, with_control=control)


@pytest.mark.parametrize("cell", ["tiny.serve", "tiny4.serve"])
def test_tiny_cell_runs_correct(tmp_path, cell):
    res = _run(tmp_path, cell, control=True)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"decisions_per_s", "setup_s"}  # no peak memory on the CPU
    assert res["checks"]["greedy_tokens_compared"]["value"] >= 1
    # the control, one precision lower, reads above the program (its
    # separation from the limit is held on the card, at the cells' size)
    assert res["info"]["control_mean_gap"] > res["info"]["mean_logit_gap"]


def _alter_tokens(engine):
    """A token altered where it is produced: the second token of every
    row of every call."""
    loop = engine._decode_loop

    def altered(*a, **k):
        out, steps = loop(*a, **k)
        out = out.clone()
        out[:, 1] = ord("z")
        return out, steps

    engine._decode_loop = altered


def _drop_half(engine):
    """Half of each batch left out: its rows come back with no answer."""
    guided = engine._run_guided

    def half(parts, schemas, temperature, max_tokens, top_p=1.0):
        texts = guided(parts, schemas, temperature, max_tokens, top_p)
        n = len(texts) // 2
        return texts[:len(texts) - n] + [""] * n

    engine._run_guided = half


def _stale_step(engine):
    """A decode step that returns its state unchanged: every step after
    a loop's first hands back that first step's logits and cache."""
    import bcg_tpu_torch.engine.torch_engine as te

    real = te.decode_step
    memo = {}

    def stale(params, spec, tokens, pos, *rest, **kw):
        key = id(rest[1])  # the call's cache
        if key not in memo:
            memo.clear()
            memo[key] = real(params, spec, tokens, pos, *rest, **kw)
        return memo[key]

    te.decode_step = stale
    engine._restore_fault = lambda: setattr(te, "decode_step", real)


@pytest.mark.parametrize("fault", [_alter_tokens, _drop_half, _stale_step],
                         ids=["token-altered", "half-batch-left-out", "state-unchanged"])
def test_faults_turn_correct_false(tmp_path, fault):
    holder = {}

    def boot(engine):
        holder["e"] = engine
        fault(engine)

    try:
        res = _run(tmp_path, "tiny.serve", after_boot=boot)
    finally:
        restore = getattr(holder.get("e"), "_restore_fault", None)
        if restore:
            restore()
    assert res["correct"] is False, res["checks"]


# ------------------------------------------------- refusal and imports

def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                          BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA card" in out.stderr


def test_a_run_loads_no_jax(tmp_path):
    """A whole tiny run in a fresh process, then the loaded modules'
    top-level names, taken whole: no ``jax``, ``jaxlib``, ``flax`` or
    ``bcg_tpu`` (``bcg_tpu_torch`` is the port)."""
    bench = _tiny_bench(tmp_path)
    code = f"""
import json, sys, time
from h100_bench import run
from h100_bench.registry import Registry
reg = Registry({bench!r}, [{DATA!r}])
res = run.execute(reg.cell("tiny.serve"), 7, 0.2, False, "cpu", t_start=time.perf_counter(), registry=reg)
import h100_bench.control, h100_bench.trace
print(json.dumps({{"forbidden": run.forbidden_modules(), "port": "bcg_tpu_torch" in sys.modules,
                  "correct": res["correct"]}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True, "correct": True}


def test_forbidden_names_are_compared_whole(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bcg_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxy.sub", sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()


# ------------------------------------------------------------- on the card

@pytest.mark.requires_cuda
def test_control_on_card():
    """The control at a cell's own size: the float8 reading lies above
    the cell's limit and the program's below it (three seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "-m", "h100_bench.control", "--workload",
                          BENCH["workloads"][0]["name"], "--seeds", "7001,7002,7003"],
                         capture_output=True, text=True, cwd=ROOT, timeout=1800)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert len(lines) == 3
    for line in lines:
        assert line["max_logit_gap"] <= line["limit"] < line["control_max_gap"]
