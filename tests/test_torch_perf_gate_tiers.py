"""The port's perf gate, sweep, chaos, scenarios and alerts scenarios
(``bcg_tpu_torch/tools/perf_gate.py``) over the copied fake engine, the
scheduler's tenancy, the chaos and recovery tier, the scenario registry
and the alert plane: each runs once in a module fixture against
``tools/perf_baseline.json``, and this file holds their namespaces to the
gate's contract (``_torch_gate_contract``).  They pass the JAX package's
entries with no difference to give.  ``alerts`` runs last: it resets
the counter registry."""

import pytest

import _torch_gate_contract as contract
from bcg_tpu_torch.tools import perf_gate

NAMESPACES = ("sweep", "chaos", "scenarios", "alerts")


@pytest.fixture(scope="module")
def gate():
    measured = {}
    for ns in NAMESPACES:
        measured.update(perf_gate.RUNNERS[ns]())
    return measured


def test_gate_passes(gate):
    contract.assert_green(gate, NAMESPACES)


def test_every_entry_is_matched_by_a_measurement(gate):
    contract.assert_every_entry_measured(gate, NAMESPACES)


@pytest.mark.parametrize("namespace", NAMESPACES)
def test_removing_an_entry_resurfaces_its_finding(gate, namespace):
    for name in contract.entries_of([namespace]):
        contract.assert_removal_resurfaces(gate, name)


def test_shared_metrics_pass_the_jax_entries(gate):
    contract.assert_passes_jax_or_says_why(gate, NAMESPACES)


def test_every_injected_fault_recovers(gate):
    assert gate["chaos.completed_fraction"] == 1.0
    assert gate["chaos.dispatch_retries"] == 3 and gate["chaos.engine_rebuilds"] == 1
    assert gate["alerts.chaos_alerts_fired"] == 3 and gate["alerts.false_positives"] == 0


@pytest.mark.parametrize("inject,namespace,metrics", [
    ("fairness-off", "sweep", ["sweep.starvation_ratio"]),
    ("chaos-off", "chaos", ["chaos.dispatch_retries", "chaos.recoveries",
                            "chaos.engine_rebuilds", "chaos.faults_injected",
                            "chaos.sweep_jobs_retried"]),
    ("scenarios-off", "scenarios", ["scenarios.influence_disrupt",
                                    "scenarios.strategies_covered",
                                    "scenarios.equivocation_divergence_rows",
                                    "scenarios.clique_shared_target_agreement"]),
    ("alerts-off", "alerts", ["alerts.rules_evaluated", "alerts.chaos_alerts_fired",
                              "alerts.fault_coverage", "alerts.healthz_flip",
                              "alerts.event_stream_ok"]),
])
def test_injected_regression_fails_naming_its_metrics(gate, inject, namespace, metrics):
    contract.assert_injection_named(perf_gate.RUNNERS[namespace](inject=inject), metrics)
