"""The port's hermetic perf gate (``bcg_tpu_torch/tools/perf_gate.py`` +
``tools/perf_baseline.json``): the serve, engine and consensus scenarios,
and the gate's own contracts (``tests/test_perf_gate.py``'s, over the
port):

* green at head;
* an injected regression fails with its metric and band named;
* every entry has a reason and a band, every namespace an owning test
  file (``_torch_gate_contract.NAMESPACE_OWNERS``), and removing an entry
  resurfaces its finding; a stale entry is a finding;
* every metric that shares its name with the JAX package's
  ``perf_baseline.json`` passes that entry or says why not, and the
  fake-engine scenarios pass it with no such reason;
* the module exits 0 green and 2 on a regression.

The other namespaces' scenarios run in the files the owner map names.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_gate_contract as contract
from bcg_tpu_torch.tools import gate_baseline, perf_gate

NAMESPACES = ("serve", "engine", "consensus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gate():
    measured = {}
    for ns in NAMESPACES:
        measured.update(perf_gate.RUNNERS[ns]())
    return measured


class TestGreenAtHead:
    def test_gate_passes(self, gate):
        contract.assert_green(gate, NAMESPACES)

    def test_scenarios_measure_the_advertised_metrics(self, gate):
        for name in ("engine.decode_steps_per_decision", "engine.spec_step_reduction",
                     "engine.spec_acceptance_rate", "engine.steady_state_retraces",
                     "serve.completed_fraction", "serve.rows_per_dispatch",
                     "serve.spec_acceptance_rate", "consensus.convergence_rate",
                     "consensus.rounds_to_consensus_mean",
                     "consensus.event_schema_completeness", "consensus.events_dropped",
                     "consensus.histogram_quantile_sanity"):
            assert name in gate, sorted(gate)

    def test_consensus_games_converge_with_complete_schemas(self, gate):
        assert gate["consensus.convergence_rate"] == 1.0
        assert gate["consensus.event_schema_completeness"] == 1.0
        assert gate["consensus.events_dropped"] == 0
        assert gate["consensus.histogram_quantile_sanity"] == 1.0

    def test_steady_state_notes_no_signature(self, gate):
        assert gate["engine.steady_state_retraces"] == 0

    def test_speculation_reduces_decode_iterations(self, gate):
        assert gate["engine.spec_step_reduction"] >= 0.30
        assert gate["engine.error_rows"] == 0


class TestInjectedRegression:
    def test_spec_off_fails_with_named_metric_and_tolerance(self, gate):
        contract.assert_injection_named(perf_gate.run_serve_scenario(inject="spec-off"),
                                        ["serve.spec_acceptance_rate"])

    def test_failing_rows_fail_the_gate(self, gate):
        contract.assert_injection_named(perf_gate.run_serve_scenario(inject="fail-rows"),
                                        ["serve.error_row_fraction"])

    def test_events_off_fails_rather_than_passing_vacuously(self, gate):
        contract.assert_injection_named(
            perf_gate.run_consensus_scenario(inject="events-off"),
            ["consensus.event_schema_completeness", "consensus.convergence_rate"])


class TestBaselineLoadBearing:
    def test_every_entry_has_a_reason_and_band(self):
        metrics = contract.baseline()["metrics"]
        assert metrics
        for name, entry in metrics.items():
            assert entry.get("reason", "").strip(), name
            assert entry.get("op") in ("min", "max", "range"), name
            assert "value" in entry and "tol_rel" in entry and "tol_abs" in entry, name

    def test_every_baseline_namespace_has_an_owner(self):
        namespaces = {n.split(".", 1)[0] for n in contract.baseline()["metrics"]}
        assert namespaces == set(contract.NAMESPACE_OWNERS), (
            f"baseline namespaces {sorted(namespaces)} against the owner map "
            f"{sorted(contract.NAMESPACE_OWNERS)}")
        assert set(perf_gate.SCENARIOS) == namespaces
        for ns, owner in contract.NAMESPACE_OWNERS.items():
            assert os.path.exists(os.path.join(contract.REPO, owner)), (ns, owner)

    def test_every_entry_is_matched_by_a_measurement(self, gate):
        contract.assert_every_entry_measured(gate, NAMESPACES)

    @pytest.mark.parametrize("namespace", NAMESPACES)
    def test_removing_an_entry_resurfaces_its_finding(self, gate, namespace):
        for name in contract.entries_of([namespace]):
            contract.assert_removal_resurfaces(gate, name)

    def test_stale_entry_is_a_finding(self, gate):
        baseline = json.loads(json.dumps(contract.baseline()))
        baseline["metrics"]["serve.ghost_metric"] = {"value": 1, "op": "min",
                                                     "reason": "synthetic"}
        stale = gate_baseline.check_stale(gate, baseline, ("serve", "engine"))
        assert any("serve.ghost_metric" in f for f in stale), stale

    def test_skipped_scenarios_entries_are_not_stale(self, gate):
        serve_only = {k: v for k, v in gate.items() if k.startswith("serve.")}
        assert gate_baseline.check_stale(serve_only, contract.baseline(), ("serve",)) == []

    def test_update_keeps_reasons_and_bands(self, gate, tmp_path):
        path = str(tmp_path / "perf_baseline.json")
        with open(path, "w") as f:
            json.dump(contract.baseline(), f)
        gate_baseline.update_baseline({"serve.rows_per_dispatch": 12.0,
                                       "serve.new_metric": 3.0}, path)
        written = gate_baseline.load_baseline(path)["metrics"]
        old = contract.baseline()["metrics"]["serve.rows_per_dispatch"]
        assert written["serve.rows_per_dispatch"] == dict(old, value=12.0)
        assert written["serve.new_metric"]["reason"].startswith("pinned by")
        assert written["engine.error_rows"] == contract.baseline()["metrics"]["engine.error_rows"]


class TestAgainstTheJaxBaseline:
    def test_shared_metrics_pass_the_jax_entry_or_say_why(self, gate):
        contract.assert_passes_jax_or_says_why(gate, NAMESPACES)

    def test_every_port_metric_has_a_jax_namesake(self):
        with open(contract.JAX_BASELINE) as f:
            jax_names = set(json.load(f)["metrics"])
        assert set(contract.baseline()["metrics"]) <= jax_names

    def test_fake_engine_scenarios_need_no_differs_reason(self):
        for name in contract.entries_of(contract.FAKE_ENGINE_NAMESPACES):
            reason = contract.baseline()["metrics"][name]["reason"]
            assert not reason.startswith(contract.DIFFERS), name


class TestScriptExitCodes:
    def _run(self, *args):
        return subprocess.run(
            [sys.executable, "-m", "bcg_tpu_torch.tools.perf_gate", "--scenarios", "serve",
             *args], cwd=contract.REPO, capture_output=True, text=True, timeout=120)

    def test_green_scenario_exits_zero(self):
        proc = self._run()
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "perf gate green" in proc.stderr

    def test_injected_regression_exits_two_and_names_metric(self):
        proc = self._run("--inject-regression", "spec-off")
        assert proc.returncode == 2, proc.stdout + proc.stderr
        assert "PERF REGRESSION: serve.spec_acceptance_rate" in proc.stderr

    def test_unknown_scenario_is_a_usage_error(self):
        proc = subprocess.run(
            [sys.executable, "-m", "bcg_tpu_torch.tools.perf_gate", "--scenarios", "fleet"],
            cwd=contract.REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 1, proc.stdout + proc.stderr
