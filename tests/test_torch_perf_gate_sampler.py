"""The port's perf gate, sampler, megaround and compile scenarios
(``bcg_tpu_torch/tools/perf_gate.py``): each runs once in a module
fixture against ``tools/perf_baseline.json``, and this file holds their
namespaces to the gate's contract (``_torch_gate_contract``)."""

import pytest
import torch

import _torch_gate_contract as contract
from bcg_tpu_torch.tools import perf_gate

NAMESPACES = ("sampler", "megaround", "compile")


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


def test_fused_sampler_is_the_reference_sampler(gate):
    assert gate["sampler.parity_mismatches"] == 0
    assert gate["sampler.fused_kernel_invocations"] > 0


def test_fused_round_is_the_lockstep_oracle(gate):
    assert gate["megaround.decision_mismatches"] == 0
    assert gate["megaround.vote_mismatches"] == 0
    assert gate["megaround.steady_retraces"] == 0


def test_every_retrace_has_a_cause(gate):
    assert gate["compile.retrace_cause_coverage"] == 1.0
    assert gate["compile.steady_state_retraces"] == 0


def test_the_plain_sampler_swap_is_undone():
    from bcg_tpu_torch.engine import speculative, torch_engine
    from bcg_tpu_torch.ops.guided_sampler import make_fused_sampler

    with perf_gate._plain_sampler():
        assert torch_engine.make_fused_sampler is speculative.make_masked_sampler
    assert torch_engine.make_fused_sampler is make_fused_sampler


def test_failing_rows_fail_the_gate(gate):
    contract.assert_injection_named(perf_gate.run_sampler_scenario(inject="fail-rows"),
                                    ["sampler.parity_mismatches"])


def test_compile_off_fails_rather_than_passing_vacuously(gate):
    contract.assert_injection_named(perf_gate.run_compile_scenario(inject="compile-off"),
                                    ["compile.retrace_cause_coverage",
                                     "compile.compile_cache_entries"])
