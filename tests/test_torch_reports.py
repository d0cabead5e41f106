"""The five report scripts (``scripts/{consensus,trace,compile,fleet,
alert}_report.py``, stdlib-only, unedited) over the files the port's
sinks write, run through ``bcg_tpu_torch.tools.reports``:

* each exits 0 on a tiny ``TorchEngine`` game's event stream, trace,
  compile-cause stream and metric shards, and on a fake-engine chaos run's
  alert stream, and its headline figures agree with what the run's own
  modules counted;
* where both packages play the same fake-engine game (or the same chaos
  run), each script prints the same on the port's files as on the JAX
  package's, with directories, times and timestamps masked.

Each run is a process of its own (``tests/_torch_report_run.py``), so the
counter registries the trace and the shards carry hold that run alone.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from bcg_tpu_torch.tools import reports

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "_torch_report_run.py")
NAMES = ("consensus_report", "trace_report", "compile_report", "fleet_report",
         "alert_report")


def _run(pkg, mode, out):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, RUNNER, pkg, mode, str(out)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(os.path.join(out, "figures.json")) as f:
        return json.load(f)


def _files(game_dir, alerts_dir):
    return dict(events=os.path.join(game_dir, "events.jsonl"),
                trace=os.path.join(game_dir, "trace.json"),
                compile_events=os.path.join(game_dir, "compile.jsonl"),
                shards=os.path.join(game_dir, "shards"),
                alerts=os.path.join(alerts_dir, "alerts.jsonl"))


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_reports")
    figures = _run("bcg_tpu_torch", "engine", root / "engine")
    alert_figures = _run("bcg_tpu_torch", "alerts", root / "alerts")
    return figures, alert_figures, reports.run_all(**_files(root / "engine", root / "alerts"))


@pytest.fixture(scope="module")
def both_packages(tmp_path_factory):
    """Each package's fake-engine game and chaos run: {pkg: {name: masked
    output}}."""
    root = tmp_path_factory.mktemp("shared_reports")
    out = {}
    for pkg in ("bcg_tpu", "bcg_tpu_torch"):
        _run(pkg, "fake", root / pkg / "fake")
        _run(pkg, "alerts", root / pkg / "alerts")
        files = _files(root / pkg / "fake", root / pkg / "alerts")
        out[pkg] = {}
        for name, args in reports.commands(**files).items():
            proc = reports.run(name, args)
            assert proc.returncode == 0, (pkg, name, proc.stderr)
            out[pkg][name] = _mask(proc.stdout, str(root / pkg))
    return out


def _mask(text, root):
    """The output with the run's directory, times and timestamps masked
    and runs of spaces made one (a column's width follows its widest
    time); the rows of the span table, ordered by time, sorted by name."""
    text = text.replace(root, "<dir>")
    text = re.sub(r"\d\d:\d\d:\d\d\.\d{3}", "<time>", text)
    text = re.sub(r"\d+(\.\d+)?e[+-]\d+|\d+\.\d+", "<x>", text)
    text = re.sub(r" +", " ", text)
    lines = text.splitlines()
    if lines and lines[0].startswith("== span latency"):
        end = lines.index("") if "" in lines else len(lines)
        lines[2:end] = sorted(lines[2:end])
    return "\n".join(lines)


@pytest.mark.parametrize("name", NAMES)
def test_each_report_exits_zero_on_the_ports_files(port_run, name):
    results = port_run[2]
    assert results[name]["rc"] == 0, results[name]


def test_consensus_report_reads_the_games_rounds(port_run):
    figures, _, results = port_run
    assert results["consensus_report"]["games"] == 1
    assert results["consensus_report"]["rounds"] == figures["rounds"]


def test_trace_report_reads_the_auditors_syncs(port_run):
    figures, _, results = port_run
    assert results["trace_report"]["host_syncs"] == figures["host_syncs_total"] > 0
    assert results["trace_report"]["host_syncs_attributed"] == figures["host_syncs_total"]
    assert {"round", "engine.decode", "engine.prefill"} <= set(results["trace_report"]["spans"])


def test_trace_report_census_has_one_row_an_entry(port_run):
    """The census gauges name each decode loop once: a per-kind table
    (``calls_<kind>``) is no row of its own."""
    figures, _, results = port_run
    assert set(results["trace_report"]["census"]) == set(figures["census"]) == {"decode_loop"}


def test_compile_report_lists_the_ports_seams(port_run):
    figures, _, results = port_run
    comp = results["compile_report"]
    assert comp["entries"] == {"pad_batch": {"compiles": 1, "retraces": 0}}
    assert comp["cache_entries"] == figures["compile"]["cache_entries"] == 1


def test_fleet_report_merges_the_one_shard(port_run):
    assert port_run[2]["fleet_report"]["runs"] == {"reports": 1}


def test_alert_report_reads_the_engines_transitions(port_run):
    _, alert_figures, results = port_run
    alert = results["alert_report"]
    assert alert["fired"] == alert_figures["fired"] == 3
    assert alert["resolved"] == alert_figures["resolved"] == 3
    assert alert["rules"] == ["dispatch_retries", "engine_errors", "engine_rebuilt"]


@pytest.mark.parametrize("name", NAMES)
def test_output_equals_the_jax_packages_on_a_shared_game(both_packages, name):
    assert both_packages["bcg_tpu_torch"][name] == both_packages["bcg_tpu"][name]
