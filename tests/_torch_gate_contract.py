"""The contract every owner of a namespace of the port's perf gate
(``bcg_tpu_torch/tools/perf_gate.py`` + ``tools/perf_baseline.json``)
asserts over the scenarios it runs, as ``tests/test_perf_gate.py`` does
for the JAX package's gate:

* green at head: every measured metric inside its band, no stale entry;
* the baseline is load-bearing: every entry of the namespace is matched
  by a measurement, and removing one resurfaces an "unbaselined metric"
  finding;
* an injected regression fails with its metric named;
* every metric that shares its name with an entry of the JAX package's
  ``perf_baseline.json`` passes that entry, or its reason says why not.

``NAMESPACE_OWNERS`` maps each namespace to the test file that runs its
scenario (``tests/test_torch_perf_gate.py`` asserts the map against the
baseline in both directions).
"""

import json
import os

from bcg_tpu_torch.tools import gate_baseline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BASELINE = os.path.join(REPO, "perf_baseline.json")
DIFFERS = "differs from the JAX package:"

NAMESPACE_OWNERS = {
    "serve": "tests/test_torch_perf_gate.py",
    "engine": "tests/test_torch_perf_gate.py",
    "consensus": "tests/test_torch_perf_gate.py",
    "paged": "tests/test_torch_perf_gate_paged.py",
    "int4": "tests/test_torch_perf_gate_paged.py",
    "hostsync": "tests/test_torch_perf_gate_paged.py",
    "sampler": "tests/test_torch_perf_gate_sampler.py",
    "megaround": "tests/test_torch_perf_gate_sampler.py",
    "compile": "tests/test_torch_perf_gate_sampler.py",
    "sweep": "tests/test_torch_perf_gate_tiers.py",
    "chaos": "tests/test_torch_perf_gate_tiers.py",
    "scenarios": "tests/test_torch_perf_gate_tiers.py",
    "alerts": "tests/test_torch_perf_gate_tiers.py",
    "hlo": "tests/test_torch_census_gate.py",
}
# The scenarios whose engine is the copied fake engine: they pass the JAX
# package's entries with no "differs" reason.
FAKE_ENGINE_NAMESPACES = ("serve", "sweep", "chaos", "scenarios", "alerts", "consensus")


def baseline():
    return gate_baseline.load_baseline()


def entries_of(namespaces):
    prefixes = tuple(f"{ns}." for ns in namespaces)
    return sorted(n for n in baseline()["metrics"] if n.startswith(prefixes))


def assert_green(measured, namespaces):
    findings = gate_baseline.check_metrics(measured, baseline())
    findings += gate_baseline.check_stale(measured, baseline(), namespaces)
    assert findings == [], "\n".join(findings)


def assert_every_entry_measured(measured, namespaces):
    missing = [n for n in entries_of(namespaces) if n not in measured]
    assert not missing, missing
    assert entries_of(namespaces), namespaces


def assert_removal_resurfaces(measured, name):
    pruned = json.loads(json.dumps(baseline()))
    del pruned["metrics"][name]
    findings = gate_baseline.check_metrics(measured, pruned)
    assert any(name in f and "no entry" in f for f in findings), (name, findings)


def assert_injection_named(measured, metrics):
    """Each of ``metrics`` is named by a finding of ``measured``."""
    findings = gate_baseline.check_metrics(measured, baseline())
    for metric in metrics:
        hits = [f for f in findings if f.startswith(metric + ":")]
        assert hits, (metric, findings)
        assert "tol_rel" in hits[0] and "required" in hits[0], hits[0]


def assert_passes_jax_or_says_why(measured, namespaces):
    with open(JAX_BASELINE) as f:
        jax_entries = json.load(f)["metrics"]
    ours = baseline()["metrics"]
    for name, got in measured.items():
        if name.split(".", 1)[0] not in namespaces or name not in jax_entries:
            continue
        if gate_baseline.passes(got, jax_entries[name]):
            continue
        assert ours[name]["reason"].startswith(DIFFERS), (
            f"{name}: measured {got} on the port misses the JAX package's entry "
            f"{jax_entries[name]} and its reason does not say why")
        assert name.split(".", 1)[0] not in FAKE_ENGINE_NAMESPACES, name
