"""The sweep over a world of ranks (``python -m bcg_tpu_torch.sweep run
... --coordinator/--distributed``, the cooperative single-job mode):
the JAX package's two-process sweep tests (``tests/test_sweep.py``'s
``TestTwoProcessSweep``) over the port's CLI on the CPU, each rank a
process joined over gloo, each world under a wall limit.

* ``CLUSTER_SPEC``'s twelve fake-engine jobs partitioned over two ranks,
  killed mid-sweep and resumed: the completed job set is the spec's, no
  game ended twice, and the merged per-job outcomes equal both the port's
  single-process sweep and the JAX package's ``run_sweep`` of the spec.
* One fake-engine job runs cooperatively: one manifest (rank 0's), one
  game, both ranks ``completed == 1``.
* One ``TorchEngine(tiny-test)`` job at dp 2 with the SPMD exchange
  (``tools/scale_sweep`` under ``tools/coop_probe``): no failed row, the
  ranks' games, engine calls and weights equal, and the recorded
  deliveries equal the dense ``masked_exchange``'s.
* ``--distributed`` joins the world from ``env://`` (as ``torchrun`` sets
  it).
"""

import glob
import importlib.util
import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

import _torch_jax_obs_state
from bcg_tpu.sweep import run_sweep as j_run_sweep
from bcg_tpu_torch.sweep import completed_job_ids, expand, run_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_LIMIT_S = 240

# tests/test_sweep.py's CLUSTER_SPEC.
CLUSTER_SPEC = {
    "name": "cluster-grid",
    "base": {"max_rounds": 6, "byzantine": 0},
    "axes": {
        "agents": [4, 5],
        "fake_policy": ["consensus", "stubborn"],
        "seed": [0, 1, 2],
    },
}


@pytest.fixture(autouse=True, scope="module")
def _jax_state():
    with _torch_jax_obs_state.restored():
        yield


def _env(run_id, linger_ms, **extra):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", BCG_TPU_RUN_ID=run_id,
               BCG_TPU_SERVE_CHECKPOINT_EVERY="1", BCG_TPU_SERVE_LINGER_MS=str(linger_ms),
               **extra)
    env.pop("BCG_TPU_GAME_EVENTS", None)
    return env


def _run_cmd(out_dir, spec_path, *flags):
    return [sys.executable, "-m", "bcg_tpu_torch.sweep", "run", spec_path, "--out", out_dir,
            "--device", "cpu", "--json", *flags]


def _launch(tmp_path, out_dir, spec_path, run_id, linger_ms):
    """Two ranks joined through a fresh FileStore (``--coordinator
    file://``)."""
    store = str(tmp_path / f"store-{run_id}")
    return [subprocess.Popen(
        _run_cmd(out_dir, spec_path, "--coordinator", f"file://{store}",
                 "--num-processes", "2", "--process-id", str(rank)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(run_id, linger_ms), cwd=REPO) for rank in range(2)]


def _finish(procs):
    """Each rank's summary; a rank that fails or passes the limit fails
    the test with its output (every rank is killed first)."""
    deadline = time.monotonic() + WORLD_LIMIT_S
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"rank exited {p.returncode}:\n{out[-2000:]}\n{err[-3000:]}"
            outs.append(json.loads(out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _write_spec(tmp_path, spec, name="spec.json"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        json.dump(spec, f)
    return path


def _outcomes_by_job(out_dir):
    """job -> (converged, rounds to consensus) over ended games, through
    the consensus report's parser; a job that ended twice fails."""
    spec = importlib.util.spec_from_file_location(
        "consensus_report_cluster", os.path.join(REPO, "scripts", "consensus_report.py"))
    cr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cr)
    games, problems = [], []
    for path in sorted(glob.glob(os.path.join(out_dir, "events-*.jsonl"))):
        games.extend(cr.parse_file(path, problems))
    assert cr.duplicate_job_problems(games) == []
    return {g.job: (g.converged, g.rounds_to_consensus) for g in games if g.ended and g.job}


def test_kill_resume_matches_single_process_and_the_jax_package(tmp_path):
    out = str(tmp_path / "cluster")
    os.makedirs(out)
    spec_path = _write_spec(tmp_path, CLUSTER_SPEC)

    # Phase 1: a slowed scheduler (40 ms linger a dispatch), both ranks
    # killed once two jobs completed.
    procs = _launch(tmp_path, out, spec_path, "torchsweeprun1", 40)
    deadline = time.monotonic() + WORLD_LIMIT_S
    try:
        while time.monotonic() < deadline:
            if len(completed_job_ids(out)) >= 2 or all(p.poll() is not None for p in procs):
                break
            time.sleep(0.01)
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
            p.communicate()
    after_kill = set(completed_job_ids(out))
    assert after_kill

    # Phase 2: the same command into the same directory, full speed.
    summaries = _finish(_launch(tmp_path, out, spec_path, "torchsweeprun2", 0))
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    for s in summaries:
        assert s["world"] == 2 and not s["cooperative"] and s["failed"] == 0
        assert s["partition"] == 6 and s["completed"] + s["skipped"] == 6
    jobs = {j.job_id for j in expand(CLUSTER_SPEC)}
    assert set(completed_job_ids(out)) == jobs and after_kill <= jobs

    merged = _outcomes_by_job(out)
    port = run_sweep(CLUSTER_SPEC, str(tmp_path / "one"), linger_ms=0)
    jax = j_run_sweep(CLUSTER_SPEC, str(tmp_path / "jax"), linger_ms=0)
    assert port["completed"] == jax["completed"] == 12
    assert merged == _outcomes_by_job(str(tmp_path / "one")) == _outcomes_by_job(
        str(tmp_path / "jax"))
    assert set(merged) == jobs
    assert sum(1 for converged, _ in merged.values() if converged) == 6


def test_cooperative_single_job_records_once(tmp_path):
    out = str(tmp_path / "coop")
    os.makedirs(out)
    spec = {"name": "coop", "base": {"agents": 4, "byzantine": 0, "max_rounds": 3, "seed": 1},
            "axes": {}}
    summaries = _finish(_launch(tmp_path, out, _write_spec(tmp_path, spec), "torchcooprun", 0))
    assert all(s["cooperative"] and s["completed"] == 1 and s["failed"] == 0
               for s in summaries)
    assert glob.glob(os.path.join(out, "sweep-manifest-r*.jsonl")) == [
        os.path.join(out, "sweep-manifest-r0.jsonl")]
    with open(os.path.join(out, "sweep-manifest-r0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    header = next(r for r in records if r["event"] == "manifest")
    assert header["process_count"] == 2 and header["cooperative"] is True
    assert header["run_id"] == "torchcooprun"
    ends = [r for r in records if r["event"] == "job_end"]
    assert len(ends) == 1 and ends[0]["status"] == "completed"
    merged = _outcomes_by_job(out)
    assert len(merged) == 1
    (outcome,) = merged.values()
    assert outcome[0] is True          # 4 honest consensus-policy agents


def test_cooperative_torch_engine_at_dp2_plays_one_game(tmp_path):
    from bcg_tpu_torch.tools import coop_probe, scale_sweep

    out = str(tmp_path / "dp2")
    row = scale_sweep.run(
        ["--device", "cpu", "--ranks", "2", "--agents", "4", "--rounds", "1", "--seed", "0",
         "--max-model-len", "0", "--decide-tokens", "96", "--vote-tokens", "48",
         "--sweep-dir", out],
        hook="bcg_tpu_torch.tools.coop_probe:probe", limit_s=WORLD_LIMIT_S)
    assert row["dp"] == row["spmd_mesh_dp"] == 2 and row["dp_batches"] >= 2
    r0, r1 = coop_probe.read_probes(out)
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for r in (r0, r1):
        assert r["rows"] > 0 and r["failed_rows"] == 0
        assert r["collectives"]["all_gather"] > 0
    assert r0["game"] is not None and r0["game_digest"] == r1["game_digest"]
    assert r0["dispatches"] and r0["dispatches"] == r1["dispatches"]
    assert r0["weights"] == r1["weights"]
    (events,) = glob.glob(os.path.join(out, "events-*.jsonl"))
    assert os.path.basename(events).startswith("events-r0-")
    rounds, receivers, bad = coop_probe.exchange_mismatches(events, r0["game"]["decisions"])
    assert (rounds, receivers, bad) == (1, 4, 0)


def test_distributed_joins_the_world_from_env(tmp_path):
    spec = {"name": "two", "base": {"agents": 4, "byzantine": 1, "max_rounds": 3},
            "axes": {"seed": [0, 1]}}
    spec_path = _write_spec(tmp_path, spec)
    out = str(tmp_path / "env")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        _run_cmd(out, spec_path, "--distributed"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=_env("torchenvrun", 0, RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                 MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))) for rank in range(2)]
    summaries = _finish(procs)
    assert sorted(s["rank"] for s in summaries) == [0, 1]
    assert all(s["world"] == 2 and s["partition"] == s["completed"] == 1 for s in summaries)
    assert set(completed_job_ids(out)) == {j.job_id for j in expand(spec)}
