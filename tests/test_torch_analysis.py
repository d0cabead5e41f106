"""The PyTorch port's static checker (``bcg_tpu_torch.analysis``).

Four layers:

1. fixture tests — every rule of the port's ``ALL_RULES`` fires on its
   seeded-violation fixture and stays quiet on the clean-idiom twin
   (``tests/torch_analysis_fixtures/``, torch idioms; the capture rules
   run under roots the tests declare for the fixtures; the three mesh
   rules retargeted to ``parallel/`` included), and the catalog is the
   JAX package's less the one rule the rules module documents as having
   no torch construct (BCG-JIT-DONATE);
2. capture regions — the ``obs_hostsync.expected()`` exemption, the
   per-step loop body as a root, the cross-module lift, and the lift
   refusing attribute calls it can only resolve by a unique name;
3. repo meta-tests — the port's run over its own scope is clean
   against ``bcg_tpu_torch/analysis/baseline.json``, every baseline entry
   is load-bearing and has a reason (a BCG-HOST-SYNC entry names the
   runtime seam that counts it), every declared capture root resolves,
   and the port's copied rules give the JAX package's checker's findings
   over the same tree;
4. the CLI.
"""

import json
import os
import re
import subprocess
import sys

import pytest

from bcg_tpu.analysis import analyze_paths as j_analyze_paths
from bcg_tpu_torch.analysis import (
    CAPTURE_ROOTS,
    RULE_IDS,
    CaptureRoot,
    analyze_paths,
    default_paths,
    load_baseline,
    repo_root,
)
from bcg_tpu_torch.analysis.core import BaselineEntry, apply_baseline
from bcg_tpu_torch.runtime import envflags

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_analysis_fixtures")
FIX_REL = "tests/torch_analysis_fixtures"

# rule ID -> (bad fixture, good fixture), paths relative to FIXTURES.
RULE_FIXTURES = {
    "BCG-HOST-SYNC": ("bad_host_sync.py", "good_host_sync.py"),
    "BCG-JIT-NP": ("bad_jit_np.py", "good_jit_np.py"),
    "BCG-JIT-BRANCH": ("bad_jit_branch.py", "good_jit_branch.py"),
    "BCG-ENV-RAW": ("bad_env_raw.py", "good_env_raw.py"),
    "BCG-ENV-UNREG": ("bad_env_unreg.py", "good_env_unreg.py"),
    "BCG-EXCEPT-BROAD": ("bad_except_broad.py", "good_except_broad.py"),
    "BCG-MUT-DEFAULT": ("bad_mut_default.py", "good_mut_default.py"),
    "BCG-LOCK-CALL": ("bad_lock_call.py", "good_lock_call.py"),
    "BCG-TIME-WALL": ("bad_time_wall.py", "good_time_wall.py"),
    "BCG-RETRY-SLEEP": ("bad_retry_sleep.py", "good_retry_sleep.py"),
    "BCG-OBS-NAME": ("bad_obs_name.py", "good_obs_name.py"),
    "BCG-OBS-BUCKET": ("bad_obs_bucket.py", "good_obs_bucket.py"),
    "BCG-LOCK-ORDER": ("bad_lock_order.py", "good_lock_order.py"),
    "BCG-LOCK-BLOCK": ("bad_lock_block.py", "good_lock_block.py"),
    "BCG-SHARED-MUT": ("bad_shared_mut.py", "good_shared_mut.py"),
    "BCG-SHARD-AXIS": ("bad_shard_axis.py", "good_shard_axis.py"),
    "BCG-SHARD-DIVISOR": ("bad_shard_divisor.py", "good_shard_divisor.py"),
    "BCG-JIT-OUTSHARD": ("models/bad_jit_outshard.py", "models/good_jit_outshard.py"),
}

# The capture roots of the fixtures (the repo's own are core.CAPTURE_ROOTS).
FIXTURE_ROOTS = [
    CaptureRoot(f"{FIX_REL}/{name}", "decode_step")
    for name in ("bad_host_sync.py", "good_host_sync.py")
] + [
    CaptureRoot(f"{FIX_REL}/{name}", "Engine.decode_loop", body="loop")
    for name in ("bad_host_sync.py", "good_host_sync.py")
] + [
    CaptureRoot(f"{FIX_REL}/bad_jit_np.py", "step"),
    CaptureRoot(f"{FIX_REL}/good_jit_np.py", "step"),
    CaptureRoot(f"{FIX_REL}/bad_jit_branch.py", "f"),
    CaptureRoot(f"{FIX_REL}/bad_jit_branch.py", "g"),
    CaptureRoot(f"{FIX_REL}/good_jit_branch.py", "f"),
    CaptureRoot(f"{FIX_REL}/xmod/entry.py", "fused_scale"),
]

# The JAX package's four mesh rules: three retargeted to the port's mesh
# code, and the one the rules module documents as having no torch construct.
MESH_RULES = {"BCG-JIT-OUTSHARD", "BCG-JIT-DONATE", "BCG-SHARD-AXIS",
              "BCG-SHARD-DIVISOR"}
NO_TORCH_CONSTRUCT = {"BCG-JIT-DONATE"}
RETARGETED = MESH_RULES - NO_TORCH_CONSTRUCT
CAPTURE_RULES = {"BCG-HOST-SYNC", "BCG-JIT-NP", "BCG-JIT-BRANCH"}
# The JAX registry's TPU-only flags the port's registry leaves out.
TPU_ONLY_FLAGS = ("BCG_TPU_ALLOW_PADDED_GROUP_KERNEL", "BCG_TPU_DISABLE_INT8_DECODE_KERNEL",
                  "BCG_TPU_PAGED_PAGES_PER_PROGRAM", "BCG_TPU_SKIP_SLOW",
                  "BCG_TPU_XLA_CACHE")


def _run_on(path, roots=FIXTURE_ROOTS):
    return analyze_paths(paths=[os.path.join(FIXTURES, path)], baseline=None,
                         roots=roots)


def _snippet(tmp_path, src, roots_for):
    """Analyze ``src`` written under the repo root's relative name of
    ``tmp_path``; ``roots_for(rel)`` gives its capture roots."""
    p = tmp_path / "snippet.py"
    p.write_text(src)
    rel = os.path.relpath(str(p), repo_root()).replace(os.sep, "/")
    return analyze_paths(paths=[str(p)], baseline=None, roots=roots_for(rel)).findings


class TestRuleFixtures:
    def test_every_rule_has_a_fixture_pair(self):
        assert sorted(RULE_FIXTURES) == sorted(RULE_IDS)
        for bad, good in RULE_FIXTURES.values():
            assert os.path.exists(os.path.join(FIXTURES, bad)), bad
            assert os.path.exists(os.path.join(FIXTURES, good)), good

    def test_catalog_is_the_jax_catalog_less_the_mesh_rules(self):
        from bcg_tpu.analysis import RULE_IDS as J_RULE_IDS

        assert set(RULE_IDS) == set(J_RULE_IDS) - NO_TORCH_CONSTRUCT
        assert len(RULE_IDS) == 18
        # Each rule left out says why, rule by rule, in the rules module.
        from bcg_tpu_torch.analysis import rules

        for rule_id in NO_TORCH_CONSTRUCT:
            assert f"{rule_id} has no torch construct" in rules.__doc__

    @pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
    def test_rule_fires_on_seeded_violation(self, rule_id):
        bad, _ = RULE_FIXTURES[rule_id]
        hits = [f for f in _run_on(bad).findings if f.rule == rule_id]
        assert hits, f"{rule_id} did not fire on {bad}"

    @pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
    def test_rule_quiet_on_clean_idiom(self, rule_id):
        _, good = RULE_FIXTURES[rule_id]
        hits = [f for f in _run_on(good).findings if f.rule == rule_id]
        assert not hits, (
            f"{rule_id} false-positive on {good}: "
            + "; ".join(f.format() for f in hits)
        )

    @pytest.mark.parametrize("rule_id,want", [
        ("BCG-HOST-SYNC", 13),
        ("BCG-JIT-NP", 2),
        ("BCG-JIT-BRANCH", 2),
        ("BCG-ENV-RAW", 6),
        ("BCG-ENV-UNREG", 4),
        ("BCG-EXCEPT-BROAD", 2),
        ("BCG-MUT-DEFAULT", 2),
        ("BCG-LOCK-CALL", 3),
        ("BCG-TIME-WALL", 3),
        ("BCG-RETRY-SLEEP", 3),
        ("BCG-OBS-NAME", 6),
        ("BCG-OBS-BUCKET", 3),
        ("BCG-LOCK-ORDER", 1),
        ("BCG-LOCK-BLOCK", 3),
        ("BCG-SHARED-MUT", 1),
        ("BCG-SHARD-AXIS", 6),
        ("BCG-SHARD-DIVISOR", 5),
        ("BCG-JIT-OUTSHARD", 2),
    ])
    def test_expected_finding_counts_on_bad_fixtures(self, rule_id, want):
        # The bad fixtures seed a known number of violations each — a
        # drop means a detection regression, not just "still fires".
        bad, _ = RULE_FIXTURES[rule_id]
        got = [f for f in _run_on(bad).findings if f.rule == rule_id]
        assert len(got) == want, "; ".join(f.format() for f in got)

    def test_every_seeded_host_read_kind_is_named(self):
        got = {f.message for f in _run_on("bad_host_sync.py").findings
               if f.rule == "BCG-HOST-SYNC"}
        for kind in (".item()", ".tolist()", ".cpu()", ".numpy()",
                     "torch.cuda.synchronize()", "bool() of a tensor",
                     "int() of a tensor", "Python if test", "Python while test",
                     "torch.nonzero()", "boolean-mask indexing", "np.asarray()"):
            assert any(kind in m for m in got), (kind, sorted(got))

    def test_tpu_only_flags_are_unregistered_in_the_port(self):
        for name in TPU_ONLY_FLAGS:
            assert name not in envflags.REGISTRY, name
        hits = [f for f in _run_on("bad_env_unreg.py").findings
                if f.rule == "BCG-ENV-UNREG" and "TPU-only" in f.content]
        assert len(hits) == 2

    def test_inline_suppression(self, tmp_path):
        src = (
            "def f(x, acc=[]):  # lint: ignore[BCG-MUT-DEFAULT]\n"
            "    return acc\n"
            "def g(x, acc=[]):\n"
            "    return acc\n"
        )
        findings = _snippet(tmp_path, src, lambda rel: ())
        muts = [f for f in findings if f.rule == "BCG-MUT-DEFAULT"]
        assert len(muts) == 1 and muts[0].line == 3


class TestCaptureRegions:
    def test_expected_sync_blocks_are_exempt(self, tmp_path):
        src = (
            "from bcg_tpu_torch.obs import hostsync as obs_hostsync\n"
            "def step(x, done):\n"
            "    with obs_hostsync.expected():\n"
            "        if bool(done.all()):\n"
            "            return x.cpu().numpy()\n"
            "    return x.sum().item()\n"
        )
        findings = _snippet(tmp_path, src, lambda rel: [CaptureRoot(rel, "step")])
        hs = [f for f in findings if f.rule == "BCG-HOST-SYNC"]
        assert [f.line for f in hs] == [6], [f.format() for f in hs]

    def test_loop_root_covers_the_step_body_only(self, tmp_path):
        src = (
            "class E:\n"
            "    def loop(self, x, n):\n"
            "        peak = x.max().item()\n"
            "        for i in range(n):\n"
            "            x = x + x.min().item()\n"
            "        return x.cpu()\n"
        )
        findings = _snippet(
            tmp_path, src, lambda rel: [CaptureRoot(rel, "E.loop", body="loop")])
        assert [f.line for f in findings if f.rule == "BCG-HOST-SYNC"] == [5]

    def test_unresolved_root_is_reported(self, tmp_path):
        p = tmp_path / "m.py"
        p.write_text("def step(x):\n    return x\n")
        rel = os.path.relpath(str(p), repo_root()).replace(os.sep, "/")
        res = analyze_paths(paths=[str(p)], baseline=None,
                            roots=[CaptureRoot(rel, "no_such_step")])
        assert [r.qualname for r in res.unresolved_roots] == ["no_such_step"]

    def test_cross_module_lift_reaches_helper(self):
        # entry.py declares the root; the .item() lives in helper.py,
        # which has no root of its own — only the whole-program lift can
        # attribute the capture region across the module boundary.
        findings = analyze_paths(paths=[os.path.join(FIXTURES, "xmod")], baseline=None,
                                 roots=FIXTURE_ROOTS).findings
        hs = [f for f in findings if f.rule == "BCG-HOST-SYNC"]
        assert len(hs) == 1, "\n".join(f.format() for f in findings)
        assert hs[0].path.endswith("xmod/helper.py")
        assert "peak = x.abs().max().item()" in hs[0].content

    def test_helper_alone_is_clean(self):
        helper = os.path.join(FIXTURES, "xmod", "helper.py")
        findings = analyze_paths(paths=[helper], baseline=None,
                                 roots=FIXTURE_ROOTS).findings
        assert not findings, "\n".join(f.format() for f in findings)

    def test_tensor_method_is_not_lifted_to_a_same_named_function(self, tmp_path):
        # ``x.chunk(2)`` on a tensor resolves, by the unique-name
        # fallback, to a function named ``chunk`` elsewhere; the lift
        # must not brand that function as captured.
        (tmp_path / "other.py").write_text(
            "def chunk(t, k):\n    return t.sum().item()\n"
        )
        src = "def step(x):\n    a, b = x.chunk(2)\n    return a + b\n"
        (tmp_path / "m.py").write_text(src)
        rel = os.path.relpath(str(tmp_path / "m.py"), repo_root()).replace(os.sep, "/")
        res = analyze_paths(paths=[str(tmp_path)], baseline=None,
                            roots=[CaptureRoot(rel, "step")])
        assert not [f for f in res.findings if f.rule in CAPTURE_RULES]


@pytest.fixture(scope="module")
def full_tree_raw():
    """ONE baseline-free run of the port's checker over its own scope,
    shared by the repo meta-tests (baseline application is a pure cheap
    function each test replays)."""
    return analyze_paths(baseline=None)


class TestRepoClean:
    def test_scope_is_the_port_and_its_card_script(self):
        names = {os.path.basename(p.rstrip(os.sep)) for p in default_paths()}
        assert names == {"bcg_tpu_torch", "chip_smoke.py"}

    def test_repo_is_clean_modulo_baseline(self, full_tree_raw):
        assert not full_tree_raw.parse_errors, full_tree_raw.parse_errors
        findings, _, unused = apply_baseline(full_tree_raw.findings, load_baseline())
        assert not findings, "\n".join(f.format() for f in findings)
        assert not unused, unused

    def test_every_capture_root_resolves(self, full_tree_raw):
        assert not full_tree_raw.unresolved_roots, full_tree_raw.unresolved_roots
        assert len(CAPTURE_ROOTS) == 6

    def test_env_raw_is_not_baselined(self, full_tree_raw):
        env_raw = [f for f in full_tree_raw.findings if f.rule == "BCG-ENV-RAW"]
        assert not env_raw, "\n".join(f.format() for f in env_raw)

    def test_baseline_entries_are_load_bearing(self, full_tree_raw):
        baseline = load_baseline()
        assert baseline, "baseline file missing or empty"
        live_keys = {f.key() for f in full_tree_raw.findings}
        for entry in baseline:
            assert entry.key() in live_keys, (
                f"baseline entry no longer matches any finding (fixed? "
                f"delete it): {entry.rule} {entry.path} {entry.content!r}"
            )
        for removed in baseline:
            remaining = [e for e in baseline if e is not removed]
            resurfaced, _, _ = apply_baseline(full_tree_raw.findings, remaining)
            assert any(f.key() == removed.key() for f in resurfaced), removed.rule

    def test_every_baseline_entry_has_a_reason(self):
        for entry in load_baseline():
            assert entry.reason.strip(), f"{entry.rule} {entry.path}"

    def test_host_sync_entries_name_a_runtime_seam(self):
        # The seams the runtime audit counts: every site the port passes
        # to obs_hostsync.note(...), plus device_sync (the card's sync
        # debug mode, obs/hostsync.py).
        pkg = os.path.join(repo_root(), "bcg_tpu_torch")
        seams = {"device_sync"}
        for dirpath, _, files in os.walk(pkg):
            for fn in files:
                if fn.endswith(".py"):
                    text = open(os.path.join(dirpath, fn), encoding="utf-8").read()
                    seams |= set(re.findall(r"hostsync\.note\(\s*\"(\w+)\"", text))
        assert {"done_poll", "round_readback"} <= seams
        entries = [e for e in load_baseline() if e.rule == "BCG-HOST-SYNC"]
        assert entries
        for e in entries:
            assert e.seam in seams, (e.content, e.seam, sorted(seams))
            assert e.seam in e.reason, e.reason

    def test_concurrency_entries_name_their_guard(self):
        guard = re.compile(r"lock|cond|thread|confin|single|serializ|GIL", re.I)
        new_rules = {"BCG-LOCK-ORDER", "BCG-LOCK-BLOCK", "BCG-SHARED-MUT"}
        checked = [e for e in load_baseline() if e.rule in new_rules]
        assert checked
        for e in checked:
            assert guard.search(e.reason), (e.rule, e.path, e.reason)

    def test_baseline_count_caps_identical_lines(self, tmp_path):
        src = (
            "def f():\n    try:\n        risky()\n"
            "    except Exception:\n        pass\n"
            "def g():\n    try:\n        risky()\n"
            "    except Exception:\n        pass\n"
        )
        p = tmp_path / "dup.py"
        p.write_text(src)
        probe = analyze_paths(paths=[str(p)], baseline=None).findings
        assert len(probe) == 2 and len({f.key() for f in probe}) == 1
        entry = BaselineEntry(rule=probe[0].rule, path=probe[0].path,
                              content=probe[0].content, reason="test", count=1)
        capped = analyze_paths(paths=[str(p)], baseline=[entry])
        assert len(capped.findings) == 1 and len(capped.baselined) == 1

    def test_copied_rules_match_the_jax_checker_over_the_port(self, full_tree_raw):
        # The same tree through both checkers: every rule the port copied
        # (all but the capture rules) finds the same (rule, path,
        # content) keys as the JAX package's own.
        jax_run = j_analyze_paths(paths=default_paths(), baseline=None)
        copied = set(RULE_IDS) - CAPTURE_RULES - RETARGETED
        mine = sorted(f.key() for f in full_tree_raw.findings if f.rule in copied)
        theirs = sorted(f.key() for f in jax_run.findings if f.rule in copied)
        assert mine == theirs
        assert mine, "expected the copied modules' parked findings"
        assert not [f for f in jax_run.findings if f.rule in MESH_RULES]
        # Each copied finding is parked with its JAX counterpart's reason.
        with open(os.path.join(repo_root(), "lint_baseline.json")) as fh:
            jax_reasons = {r["reason"] for r in json.load(fh)["suppressions"]}
        for e in load_baseline():
            if e.rule in copied:
                assert any(e.reason.startswith(r) for r in jax_reasons), e.content


class TestCli:
    def test_cli_exits_zero_on_repo(self):
        proc = subprocess.run(
            [sys.executable, "-m", "bcg_tpu_torch.analysis", "--show-baselined"],
            cwd=repo_root(), capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 findings" in proc.stderr
        assert proc.stdout.count("[baselined]") == len(load_baseline())

    def test_json_emits_finding_status(self):
        bad = os.path.join(FIXTURES, "bad_lock_block.py")
        proc = subprocess.run(
            [sys.executable, "-m", "bcg_tpu_torch.analysis", "--no-baseline", "--json", bad],
            cwd=repo_root(), capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 1, proc.stdout + proc.stderr
        payload = json.loads(proc.stdout)
        blocks = [f for f in payload["findings"] if f["rule"] == "BCG-LOCK-BLOCK"]
        assert len(blocks) == 3 and all(f["status"] == "new" for f in blocks)

    def test_locks_report_mode(self):
        proc = subprocess.run(
            [sys.executable, "-m", "bcg_tpu_torch.analysis", "--locks"],
            cwd=repo_root(), capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "thread roots:" in proc.stdout and "lock-order edges" in proc.stdout
        assert "bcg-sweep-*" in proc.stdout
        assert "Scheduler._device_lock" in proc.stdout
