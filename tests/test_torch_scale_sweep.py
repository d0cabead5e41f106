"""``python -m bcg_tpu_torch.tools.scale_sweep`` — the counterpart of
``scripts/scale_sweep.py`` over a world of ranks — on the CPU: its one
JSON line has exactly the JAX script's key set
(``tests/test_scale_sweep.EXPECTED_KEYS``), its layout fields read the
world it ran (dp 2 over two ranks: the cooperative sweep, every rank
playing the game), its sweep manifest carries the fleet identity, a
rerun into the same ``--sweep-dir`` reports the recorded row, and 5
agents on 2 ranks run at dp 1 in one process."""

import glob
import json
import os
import subprocess
import sys

from test_scale_sweep import EXPECTED_KEYS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--device", "cpu", "--ranks", "2", "--agents", "4", "--rounds", "2",
        "--max-model-len", "256", "--decide-tokens", "24", "--vote-tokens", "16"]


def _run(sweep_dir):
    proc = subprocess.run(
        [sys.executable, "-m", "bcg_tpu_torch.tools.scale_sweep", *ARGS,
         "--sweep-dir", sweep_dir],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0]), proc.stderr


def test_scale_sweep_over_two_ranks_emits_the_jax_schema(tmp_path):
    sweep_dir = str(tmp_path / "scale")
    row, _ = _run(sweep_dir)
    assert set(row) == EXPECTED_KEYS, sorted(row)
    assert row["agents"] == 4 and row["model"] == "bcg-tpu/tiny-test"
    assert row["devices"] == row["dp"] == row["spmd_mesh_dp"] == 2
    assert 1 <= row["rounds"] <= 2
    assert row["rounds_per_sec"] > 0 and row["decisions_per_sec"] > 0
    assert row["dp_batches"] >= 1 and row["dp_bypasses"] == 0
    assert isinstance(row["consensus"], bool)

    manifests = glob.glob(os.path.join(sweep_dir, "sweep-manifest-r*.jsonl"))
    assert manifests == [os.path.join(sweep_dir, "sweep-manifest-r0.jsonl")]
    with open(manifests[0]) as f:
        records = [json.loads(line) for line in f]
    header = next(r for r in records if r["event"] == "manifest")
    for key in ("run_id", "host", "process_index", "process_count", "flags",
                "schema_version"):
        assert key in header, sorted(header)
    assert header["kind"] == "sweep" and header["cooperative"] is True
    assert header["process_count"] == 2
    ends = [r for r in records if r["event"] == "job_end"]
    assert len(ends) == 1 and ends[0]["status"] == "completed"

    # A rerun into the same directory plays nothing and reports the record.
    again, err = _run(sweep_dir)
    assert "already completed" in err
    assert again == row


def test_five_agents_on_two_ranks_run_at_dp1_in_one_process(tmp_path, capsys):
    from bcg_tpu_torch.tools import scale_sweep

    sweep_dir = str(tmp_path / "five")
    args = ["--device", "cpu", "--ranks", "2", "--agents", "5", "--rounds", "1",
            "--max-model-len", "256", "--decide-tokens", "24", "--vote-tokens", "16",
            "--sweep-dir", sweep_dir]
    assert scale_sweep.main(args) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(row) == EXPECTED_KEYS
    assert (row["devices"], row["dp"], row["spmd_mesh_dp"]) == (2, 1, 1)
    assert row["dp_batches"] == 0
    with open(os.path.join(sweep_dir, "sweep-manifest-r0.jsonl")) as f:
        header = json.loads(f.readline())
    assert header["cooperative"] is False and header["world"] == 1
    assert scale_sweep.dp_for(5, 2) == 1 and scale_sweep.dp_for(10, 2) == 2
    assert scale_sweep.dp_for(12, 8) == 6
