"""The port's launch-census drift gate (``bcg_tpu_torch/tools/
census_gate.py`` + ``tools/census_baseline.json``), the counterpart of
``tests/test_hlo_census.py``:

* the CPU census of the five arms (plain, ff, spec, paged, megaround)
  matches the ``cpu`` section exactly;
* one more kernel-wrapper call in the plain decode step is a finding that
  names the entry and the metric; a removed entry resurfaces, a stale
  entry is a finding, every entry has a reason;
* a comparison with the ``cuda`` section is refused on the CPU, and that
  section (recorded on the card by ``chip_smoke.py``'s P10) is checked
  here for its shape only;
* the gate's ``hlo`` namespace (``python -m
  bcg_tpu_torch.tools.census_gate --check`` in a subprocess) is green and
  load-bearing.
"""

import json

import pytest
import torch

import _torch_gate_contract as contract
from bcg_tpu_torch.tools import census_gate, perf_gate


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def census():
    return census_gate.run_scenario()


@pytest.fixture(scope="module")
def hlo_gate():
    return perf_gate.run_hlo_scenario()


def _baseline():
    return json.loads(json.dumps(census_gate.load_baseline()))


class TestCensusScenario:
    def test_every_arm_records_its_entry(self, census):
        assert set(census) == {"decode_loop", "ff_decode_loop", "spec_decode_loop",
                               "paged_decode_loop", "megaround"}
        for entry, rec in census.items():
            assert rec["backend"] == "cpu" and "error" not in rec, (entry, rec)
            assert rec["launches"] == {}, entry      # the CPU runs the plain versions

    def test_each_step_calls_attention_once_a_layer_and_the_sampler_once(self, census):
        from bcg_tpu_torch.models.configs import spec_for_model

        layers = spec_for_model(census_gate.MODEL).num_layers
        for entry, rec in census.items():
            assert rec["calls"]["guided_sampler"] == 1, entry
            assert rec["step_custom_calls"] == layers + 1, entry

    def test_census_gauges_are_one_segment_past_the_entry(self, census):
        """``scripts/trace_report.py`` reads the segment before a census
        gauge's last dot as the entry: the per-kind tables publish as
        ``<table>_<kind>``, so no table reads as an entry of its own."""
        from bcg_tpu_torch.obs import counters as obs_counters

        names = [n for n in obs_counters.snapshot() if n.startswith("engine.hlo.")]
        assert "engine.hlo.decode_loop.calls_decode_attention" in names
        assert all(n.count(".") == 3 for n in names), names


class TestDriftGate:
    def test_census_matches_checked_in_baseline(self, census):
        findings = census_gate.check_drift(census, census_gate.load_baseline(), "cpu")
        assert findings == [], "\n".join(findings)

    def test_added_wrapper_call_in_decode_step_fails(self, monkeypatch):
        from bcg_tpu_torch.models import transformer

        attend = transformer.decode_attention

        def twice(*args, **kw):
            attend(*args, **kw)
            return attend(*args, **kw)

        monkeypatch.setattr(transformer, "decode_attention", twice)
        findings = census_gate.check_drift(census_gate.run_scenario(arms=("plain",)),
                                           census_gate.load_baseline(), "cpu")
        hits = [f for f in findings if f.startswith("decode_loop.calls.decode_attention:")]
        assert hits and "added" in hits[0], findings
        assert any(f.startswith("decode_loop.step_custom_calls:") for f in findings)

    def test_removing_baseline_entry_resurfaces_finding(self, census):
        for entry in census:
            baseline = _baseline()
            del baseline["cpu"]["entries"][entry]
            findings = census_gate.check_drift(census, baseline, "cpu")
            assert any(f.startswith(f"{entry}: new census entry") for f in findings), entry

    def test_a_kind_the_baseline_lacks_is_a_finding(self, census):
        baseline = _baseline()
        del baseline["cpu"]["entries"]["paged_decode_loop"]["counts"]["calls.paged_attention"]
        findings = census_gate.check_drift(census, baseline, "cpu")
        assert any("paged_decode_loop.calls.paged_attention" in f and "not pinned" in f
                   for f in findings), findings

    def test_stale_baseline_entry_is_a_finding(self, census):
        baseline = _baseline()
        baseline["cpu"]["entries"]["ghost_loop"] = {"reason": "synthetic", "counts": {}}
        findings = census_gate.check_drift(census, baseline, "cpu")
        assert any("'ghost_loop'" in f and "stale" in f for f in findings), findings

    def test_backend_mismatch_refuses_comparison(self, census):
        baseline = _baseline()
        baseline["cpu"]["backend"] = "cuda"
        findings = census_gate.check_drift(census, baseline, "cpu")
        assert len(findings) == 1 and "not comparable" in findings[0]

    def test_torch_version_change_is_noted(self, census):
        baseline = _baseline()
        baseline["cpu"]["torch_version"] = "0.0"
        baseline["cpu"]["entries"]["decode_loop"]["counts"]["step_custom_calls"] += 1
        findings = census_gate.check_drift(census, baseline, "cpu")
        assert findings and all("baseline torch 0.0" in f for f in findings)

    def test_every_baseline_entry_has_a_reason(self):
        for section in ("cpu", "cuda"):
            for entry, pinned in census_gate.load_baseline()[section]["entries"].items():
                assert pinned.get("reason", "").strip(), (section, entry)
                assert pinned["counts"], (section, entry)

    def test_update_keeps_reasons(self, census, tmp_path):
        path = str(tmp_path / "census_baseline.json")
        with open(path, "w") as f:
            json.dump(census_gate.load_baseline(), f)
        census_gate.update_baseline(census, path)
        written = census_gate.load_baseline(path)
        assert written["cpu"] == census_gate.load_baseline()["cpu"] | {
            "torch_version": written["cpu"]["torch_version"]}
        assert written["cuda"] == census_gate.load_baseline()["cuda"]


class TestCudaSection:
    def test_a_cuda_comparison_is_refused_on_the_cpu(self, census):
        findings = census_gate.check_drift(census, census_gate.load_baseline(), "cuda",
                                           layers=36)
        assert len(findings) == 1 and "not comparable" in findings[0], findings

    def test_another_depth_is_named(self):
        section = census_gate.load_baseline()["cuda"]
        card = {"decode_loop": {"backend": "cuda"}}
        findings = census_gate.check_drift(card, census_gate.load_baseline(), "cuda",
                                           layers=12)
        assert len(findings) == 1, findings
        assert f"pinned at {section['layers']} layers" in findings[0]
        assert "depth of 12 layers" in findings[0]

    def test_shape(self):
        """P10's decode step at bench-8b, 36 layers: the card's kernels by
        kind sum to the step's operations, the products to its dots, and
        each hand-written kernel's launches equal its kernels on the
        device (B3a once a layer, B2 once)."""
        section = census_gate.load_baseline()["cuda"]
        assert section["backend"] == "cuda" and section["layers"] == 36
        assert section["torch_version"]
        assert set(section["entries"]) == {"decode_loop"}
        pinned = section["entries"]["decode_loop"]
        counts = dict(pinned["counts"])
        for metric, band in pinned.get("bands", {}).items():
            assert band["lo"] <= band["hi"] and band["reason"].strip(), metric
            counts[metric] = band["lo"]
        assert all(m in ("step_ops", "step_dots", "step_custom_calls")
                   or m.startswith(("kernels.", "launches.")) for m in counts), counts
        kernels = {m[len("kernels."):]: n for m, n in counts.items()
                   if m.startswith("kernels.")}
        launches = {m[len("launches."):]: n for m, n in counts.items()
                    if m.startswith("launches.")}
        if not pinned.get("bands"):
            assert counts["step_ops"] == sum(kernels.values())
        assert counts["step_dots"] == kernels.get("matmul", 0) + kernels.get("int8_gemm", 0)
        assert launches == {"decode_attention": 36, "guided_sampler": 1}
        assert all(kernels[k] == n for k, n in launches.items())
        assert counts["step_custom_calls"] == sum(launches.values())


class TestHloNamespace:
    """The perf gate's ``hlo`` namespace, owned here
    (``_torch_gate_contract.NAMESPACE_OWNERS``)."""

    def test_gate_passes(self, hlo_gate):
        assert hlo_gate == {"hlo.census_drift_findings": 0.0}
        contract.assert_green(hlo_gate, ("hlo",))

    def test_every_entry_is_matched_by_a_measurement(self, hlo_gate):
        contract.assert_every_entry_measured(hlo_gate, ("hlo",))

    def test_removing_the_entry_resurfaces_its_finding(self, hlo_gate):
        contract.assert_removal_resurfaces(hlo_gate, "hlo.census_drift_findings")

    def test_a_finding_fails_the_gate(self, hlo_gate):
        contract.assert_injection_named({"hlo.census_drift_findings": 1.0},
                                        ["hlo.census_drift_findings"])
