"""The port's perf gate, paged, int4 and hostsync scenarios
(``bcg_tpu_torch/tools/perf_gate.py``): each runs once in a module
fixture against ``tools/perf_baseline.json``, and this file holds their
namespaces to the gate's contract (``_torch_gate_contract``): green at
head, every entry measured, removing one resurfaces its finding, the
injected regressions named, the JAX package's entries passed or the
difference given."""

import pytest
import torch

import _torch_gate_contract as contract
from bcg_tpu_torch.tools import perf_gate

NAMESPACES = ("paged", "int4", "hostsync")


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


def test_gate_passes(gate):
    contract.assert_green(gate, NAMESPACES)


def test_every_entry_is_matched_by_a_measurement(gate):
    contract.assert_every_entry_measured(gate, NAMESPACES)


@pytest.mark.parametrize("namespace", NAMESPACES)
def test_removing_an_entry_resurfaces_its_finding(gate, namespace):
    for name in contract.entries_of([namespace]):
        contract.assert_removal_resurfaces(gate, name)


def test_shared_metrics_pass_the_jax_entry_or_say_why(gate):
    contract.assert_passes_jax_or_says_why(gate, NAMESPACES)


def test_paged_output_is_the_dense_output(gate):
    assert gate["paged.greedy_parity_mismatches"] == 0
    assert gate["paged.pallas_parity_mismatches"] == 0
    assert gate["paged.positions_real_monotone"] == 1.0
    assert gate["paged.row_cap_gain"] > 1.0


def test_int4_doubles_the_rows_a_budget_holds(gate):
    assert gate["int4.row_cap_gain"] >= 1.8 and gate["int4.pool_blocks_gain"] >= 1.8
    assert gate["int4.paged_parity_mismatches"] == 0 and gate["int4.error_rows"] == 0


def test_one_sync_a_fused_round_six_a_lockstep_round(gate):
    assert gate["hostsync.syncs_per_round"] == 1.0
    assert gate["hostsync.syncs_per_round_lockstep"] == 6.0
    assert gate["hostsync.attribution_coverage"] == 1.0


@pytest.mark.parametrize("namespace,metric", [
    ("paged", "paged.greedy_parity_mismatches"),
    ("int4", "int4.paged_parity_mismatches"),
])
def test_failing_rows_fail_the_gate(gate, namespace, metric):
    contract.assert_injection_named(perf_gate.RUNNERS[namespace](inject="fail-rows"),
                                    [metric])


def test_hostsync_off_fails_rather_than_passing_vacuously(gate):
    contract.assert_injection_named(
        perf_gate.run_hostsync_scenario(inject="hostsync-off"),
        ["hostsync.syncs_per_round", "hostsync.syncs_per_decision",
         "hostsync.attribution_coverage"])
