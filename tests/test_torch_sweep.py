"""The sweep tier of the PyTorch port (ROADMAP A11) against the JAX
package's.

* A two-job fake-engine sweep through each package's ``run_sweep`` into
  its own directory: the same manifests (once the time, run id, host and
  pid fields are dropped), the same ``render_report`` (once the directory
  reads alike), and the same manifests again under an injected job crash
  that the retry budget absorbs.
* ``python -m bcg_tpu_torch.sweep``: ``list`` and ``expand`` print what
  the JAX package prints, and ``run --device cpu`` builds its engines on
  that device.
* Over a world of ranks (the process identity set by hand here; the real
  worlds are ``tests/test_torch_sweep_cluster.py``'s): several jobs stay a
  strided partition, and one job runs cooperatively with the retry,
  watchdog and job-retry budgets off (a retry on one rank alone would part
  the ranks).
* One greedy ``bcg-tpu/tiny-test`` job on an injected
  ``TorchEngine(device="cpu")`` completes.
"""

import json
import os

import pytest
import torch

from bcg_tpu.runtime import resilience as j_resilience
from bcg_tpu.sweep import __main__ as j_main, controller as j_controller
from bcg_tpu_torch.engine.torch_engine import TorchEngine
from bcg_tpu_torch.runtime import resilience as t_resilience
from bcg_tpu_torch.sweep import __main__ as t_main, controller as t_controller
import _torch_jax_obs_state

SPEC = {"name": "two", "base": {"agents": 4, "byzantine": 1, "max_rounds": 3},
        "axes": {"seed": [0, 1]}}
# Fields that differ between any two runs: clocks, process identity, and
# the throughput read off them.
VOLATILE = ("ts", "run_id", "pid", "host", "wall_s", "rounds_per_sec", "decisions_per_sec")


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


@pytest.fixture(autouse=True)
def _no_chaos_left(monkeypatch):
    yield
    monkeypatch.delenv("BCG_TPU_CHAOS", raising=False)
    j_resilience.reset()
    t_resilience.reset()


def _manifest(out_dir):
    with open(os.path.join(out_dir, "sweep-manifest-r0.jsonl")) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    for rec in recs:
        for key in VOLATILE:
            rec.pop(key, None)
    # Two jobs run at once: records of one job keep their order, the two
    # jobs' interleave as they will.
    return sorted(recs, key=lambda r: (r.get("job", ""), json.dumps(r, sort_keys=True)))


def _both(tmp_path, **kw):
    out = {}
    for name, ctl in (("jax", j_controller), ("torch", t_controller)):
        d = str(tmp_path / name)
        summary = ctl.run_sweep(SPEC, d, max_concurrent=2, **kw)
        report = ctl.render_report(d).replace(d, "<dir>")
        out[name] = (summary, _manifest(d), report)
    return out


def _strip_summary(summary):
    s = dict(summary, out_dir=None)
    s["results"] = [{k: v for k, v in r.items() if k not in VOLATILE} for r in s["results"]]
    return s


def test_fake_sweep_manifests_and_report_identical(tmp_path):
    out = _both(tmp_path)
    (js, jm, jr), (ts, tm, tr) = out["jax"], out["torch"]
    assert ts["completed"] == 2 and ts["failed"] == 0
    assert _strip_summary(ts) == _strip_summary(js)
    assert tm == jm
    assert tr == jr
    assert "2 jobs ended" in tr


def test_fake_sweep_with_a_retried_job_crash_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("BCG_TPU_CHAOS", "crash@sweep.job:2")
    j_resilience.reset()
    t_resilience.reset()
    out = _both(tmp_path, max_job_retries=2)
    (js, jm, _), (ts, tm, _) = out["jax"], out["torch"]
    assert ts["completed"] == 2 and ts["failed"] == 0
    failed = [r for r in tm if r.get("event") == "job_end" and r["status"] == "failed"]
    assert len(failed) == 1 and failed[0]["failure"] == "transient"
    assert tm == jm


@pytest.mark.parametrize("cmd", [["list"], ["expand", "smoke"], ["expand", "adversary-grid"]])
def test_sweep_cli_prints_what_the_jax_package_prints(cmd, capsys):
    assert j_main.main(cmd) == 0
    j = capsys.readouterr().out
    assert t_main.main(cmd) == 0
    assert capsys.readouterr().out == j


def test_sweep_cli_run_builds_engines_on_the_named_device(tmp_path, monkeypatch, capsys):
    from bcg_tpu_torch.engine import interface

    devices = []
    real = interface.create_engine

    def create(cfg, llm_config=None, device=None):
        devices.append(device)
        return real(cfg, llm_config, device=device)

    monkeypatch.setattr(interface, "create_engine", create)
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(SPEC))
    assert t_main.main(["run", str(spec), "--out", str(tmp_path / "out"),
                        "--device", "cpu"]) == 0
    assert devices == ["cpu"]          # one engine key, one engine
    assert "2 job(s), 0 failed" in capsys.readouterr().out


def test_several_jobs_over_two_ranks_stay_a_strided_partition(tmp_path):
    from bcg_tpu_torch.obs import fleet

    fleet.set_process_provider(lambda: (1, 2))
    try:
        ctl = t_controller.SweepController(SPEC, str(tmp_path))
        assert (ctl.rank, ctl.world, ctl.cooperative) == (1, 2, False)
        assert [j.job_id for j in ctl.jobs[ctl.rank::ctl.world]] == [ctl.jobs[1].job_id]
    finally:
        fleet.reset()


def test_cooperative_single_job_turns_the_retry_budgets_off(tmp_path, monkeypatch):
    from bcg_tpu_torch.obs import fleet

    monkeypatch.setenv("BCG_TPU_SERVE_WATCHDOG_S", "30")
    fleet.set_process_provider(lambda: (0, 2))
    try:
        with pytest.warns(UserWarning, match="max_job_retries, BCG_TPU_SERVE_WATCHDOG_S"):
            ctl = t_controller.SweepController({"name": "one", "base": {"agents": 3}},
                                               str(tmp_path), max_job_retries=2)
        assert ctl.cooperative and ctl.max_job_retries == 0
        (job,) = ctl.jobs
        _, scheduler = ctl._group_for(job)
        assert scheduler._watchdog_s == 0 and scheduler._max_retries == 0
        ctl._close_groups()
    finally:
        fleet.reset()


def test_torch_job_on_an_injected_cpu_engine(tmp_path):
    from bcg_tpu_torch.config import EngineConfig

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    eng = TorchEngine(EngineConfig(model_name="bcg-tpu/tiny-test", max_model_len=2048),
                      device="cpu")
    try:
        spec = {"name": "torch-one", "base": {
            "agents": 3, "byzantine": 1, "max_rounds": 1, "backend": "torch",
            "model": "bcg-tpu/tiny-test", "decide_tokens": 96, "vote_tokens": 48}}
        summary = t_controller.run_sweep(spec, str(tmp_path), engine=eng)
    finally:
        torch.set_num_threads(n)
    assert summary["completed"] == 1 and summary["failed"] == 0
    (res,) = summary["results"]
    assert res["status"] == "completed" and res["rounds"] == 1
    assert eng.total_rows > 0 and eng.failed_rows == 0
    assert eng.params                   # an injected engine stays the caller's
    eng.shutdown()
