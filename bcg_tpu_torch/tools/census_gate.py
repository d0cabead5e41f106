"""The port's launch-census drift gate: ``scripts/hlo_census.py``'s
counterpart over ``bcg_tpu_torch/obs/hlo.py``.

    python -m bcg_tpu_torch.tools.census_gate [--check] [--update-baseline]
        [--json] [--arms plain,ff,spec,paged,megaround]
    python -m bcg_tpu_torch.tools.census_gate --update-cuda CENSUS.json

On the CPU it builds tiny engines (``bcg-tpu/tiny-test``) with the census
on (``BCG_TPU_HLO_CENSUS``) and drives one guided generation per arm on
``hlo_census.py``'s two-row prompts at temperature 0 and ``max_tokens``
24: the plain, fast-forward, speculative and paged decode loops, and one
fused round (``megaround``).  Each decode-loop entry records one step:
the kernel wrappers' calls by kind (``calls.<kind>``, their sum
``step_custom_calls``); on a card also every device operation by kind
(``kernels.<kind>``, ``step_ops``, ``step_dots``) and the wrappers'
launches (``launches.<kind>``).

The JAX census has two more arms, ``paged_pallas`` and ``fused``.  Each
chooses between an XLA and a Pallas implementation of one function; the
port has one implementation of each (the paged attention kernel and the
fused sampler, their plain versions on CPU tensors), which the ``paged``
and every other arm already run, so those entries have no counterpart.

``tools/census_baseline.json`` holds two sections, each exact:

* ``cpu``: recorded here by ``--update-baseline``; per entry
  ``step_custom_calls`` and ``calls.<kind>``;
* ``cuda``: ``decode_loop`` of ``chip_smoke.py``'s P10 (P1's game at
  ``bcg-tpu/bench-8b``, 36 layers) on the card: ``step_ops``,
  ``step_dots``, ``step_custom_calls``, ``kernels.<kind>`` and
  ``launches.<kind>``, written by ``--update-cuda`` from the census P10
  saved.  A count that two card runs of the same tree read differently
  carries a band (``bands``: lo, hi and a reason) in place of its pin.

:func:`check_drift` follows ``hlo_census.py``: counts compare exactly (a
kind the step no longer runs counts 0; a kind the baseline lacks is a
finding), an entry nothing exercised is stale, a census recorded on one
backend refuses to compare with the other backend's section, a section
pinned at another depth fails naming both, and a torch-version change is
noted on every finding.  Exit status: 0 green, 2 drift, 1 usage.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Dict, List, Optional

ARMS = ("plain", "ff", "spec", "paged", "megaround")
MODEL = "bcg-tpu/tiny-test"
SCHEMA = {
    "type": "object",
    "properties": {"value": {"type": "integer", "minimum": 0, "maximum": 100}},
    "required": ["value"],
}
# hlo_census.py's deterministic two-row scenario: one system prefix (the
# prefix-cache path) and a short round prompt; temperature 0.
PROMPTS = [
    ("You are agent_1 in a consensus game.",
     "Round 1. agent_2 value: 41. Your current value: 42. Decide."),
    ("You are agent_2 in a consensus game.",
     "Round 1. agent_1 value: 42. Your current value: 41. Decide."),
]
BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "census_baseline.json")
# The census metrics each section pins: plain names, or a table's prefix
# ("calls." pins every calls.<kind>).
PINNED = {
    "cpu": ("step_custom_calls", "calls."),
    "cuda": ("step_ops", "step_dots", "step_custom_calls", "kernels.", "launches."),
}


def run_scenario(arms=ARMS) -> Dict[str, Dict]:
    """Drive the arms on the CPU and return ``obs/hlo.snapshot()``.  Arm
    order is fixed, and each entry records the first step it runs."""
    from bcg_tpu_torch.config import EngineConfig
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.obs import hlo as obs_hlo

    from bcg_tpu_torch.tools.perf_gate import env_vars

    with env_vars(BCG_TPU_HLO_CENSUS="1"):
        obs_hlo.reset()
        try:
            base = EngineConfig(backend="torch", model_name=MODEL, max_model_len=512)
            for arm in arms:
                if arm == "megaround":
                    _run_megaround_arm(dataclasses.replace(base, max_model_len=2048))
                    continue
                engine = TorchEngine(dataclasses.replace(
                    base, decode_fast_forward=(arm == "ff"), spec_decode=(arm == "spec"),
                    paged_kv=(arm == "paged"),
                ), device="cpu")
                try:
                    engine.batch_generate_json(
                        [(system, user, SCHEMA) for system, user in PROMPTS],
                        temperature=0.0, max_tokens=24,
                    )
                finally:
                    engine.shutdown()
            return obs_hlo.snapshot()
        finally:
            obs_hlo.reset()


def _run_megaround_arm(cfg) -> None:
    """One fused round of two agents: the round's decode loops record
    under the ``megaround`` entry."""
    import numpy as np

    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    engine = TorchEngine(cfg, device="cpu")
    try:
        n = 2
        plan = engine.prepare_megaround(n_agents=n, lo=0, hi=100, max_rounds=6)
        mask = np.ones((n, n), bool)
        np.fill_diagonal(mask, False)
        engine.run_megaround(plan, np.asarray([42, 41], np.int32),
                             np.full((n, n), -1, np.int32), 1, mask,
                             np.zeros(n, bool), np.asarray([42, 41], np.int32))
    finally:
        engine.shutdown()


# ---------------------------------------------------------------- baseline
def load_baseline(path: Optional[str] = None) -> Optional[Dict]:
    path = path or BASELINE
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def flat_counts(recorded: Dict, backend: str) -> Dict[str, int]:
    """One entry's census as ``{metric: count}`` over the metrics
    ``backend``'s section pins."""
    flat = {}
    for metric in PINNED[backend]:
        if metric.endswith("."):
            for kind, n in (recorded.get(metric[:-1]) or {}).items():
                flat[metric + kind] = n
        elif recorded.get(metric) is not None:
            flat[metric] = recorded[metric]
    return flat


def _torch_version() -> str:
    import torch

    return torch.__version__


def check_drift(census: Dict[str, Dict], baseline: Optional[Dict], backend: str = "cpu",
                layers: Optional[int] = None) -> List[str]:
    """Findings (empty = green) of ``census`` against the baseline's
    ``backend`` section; ``layers`` (the card's depth) must equal the
    section's when it pins one."""
    if baseline is None:
        return [f"no baseline file at {BASELINE} — run python -m "
                "bcg_tpu_torch.tools.census_gate --update-baseline"]
    section = baseline.get(backend)
    if section is None:
        return [f"{os.path.basename(BASELINE)} has no {backend!r} section"]
    ran_on = sorted({rec.get("backend") for rec in census.values()})
    if ran_on != [section.get("backend")]:
        return [f"the {backend!r} section was recorded on backend "
                f"{section.get('backend')!r} but this census ran on {ran_on} — "
                "not comparable; record each backend's section on that backend"]
    if section.get("layers") is not None and layers != section["layers"]:
        return [f"the {backend!r} section is pinned at {section['layers']} layers but "
                f"this census ran at a depth of {layers} layers — not comparable"]
    note = ""
    running = _torch_version()
    if section.get("torch_version") != running:
        note = (f" [note: baseline torch {section.get('torch_version')}, running "
                f"{running} — a library upgrade may shift the card's kernels; "
                "re-record if every entry moved]")
    entries = section.get("entries", {})
    findings: List[str] = []
    for entry, recorded in sorted(census.items()):
        if "error" in recorded:
            findings.append(f"{entry}: census recording failed: {recorded['error']}" + note)
            continue
        pinned = entries.get(entry)
        if pinned is None:
            findings.append(f"{entry}: new census entry not pinned in the {backend!r} "
                            "section — justify it with --update-baseline (and a reason)"
                            + note)
            continue
        got_all = flat_counts(recorded, backend)
        want_all = pinned.get("counts", {})
        bands = pinned.get("bands", {})
        for metric in sorted(set(want_all) | set(got_all) | set(bands)):
            got = got_all.get(metric, 0)
            if metric in bands:
                band = bands[metric]
                if not band["lo"] <= got <= band["hi"]:
                    findings.append(f"{entry}.{metric}: {got} outside the band "
                                    f"[{band['lo']}, {band['hi']}] — {band.get('reason')}"
                                    + note)
                continue
            if metric not in want_all:
                findings.append(f"{entry}.{metric}: {got}, not pinned in the baseline "
                                "(a new kind of kernel in the step)" + note)
                continue
            want = want_all[metric]
            if got != want:
                findings.append(f"{entry}.{metric}: {got} vs baseline {want} (exact-match "
                                f"metric; a kernel was {'added' if got > want else 'removed'})"
                                + note)
    for entry in sorted(entries):
        if entry not in census:
            findings.append(f"baseline entry {entry!r} of the {backend!r} section was not "
                            "exercised by the census (stale — remove it, or fix the "
                            "scenario)")
    return findings


_COMMENT = (
    "The port's launch-census baseline (python -m bcg_tpu_torch.tools.census_gate). "
    "Counts are exact per backend: 'cpu' is the hermetic CPU census (the kernel "
    "wrappers' calls a decode step), 'cuda' is chip_smoke.py P10's decode_loop step "
    "at bcg-tpu/bench-8b on the card. A count that two card runs read differently "
    "carries a band with a reason. Every entry carries a reason."
)


def _write(data: Dict, path: str) -> str:
    data = dict(data, _comment=_COMMENT)
    with open(path, "w") as f:
        json.dump(dict(sorted(data.items())), f, indent=2, ensure_ascii=False)
        f.write("\n")
    return path


def _section(census: Dict[str, Dict], backend: str, prior: Dict,
             layers: Optional[int] = None) -> Dict:
    entries = {}
    for entry, recorded in sorted(census.items()):
        if "error" in recorded:
            continue
        old = prior.get("entries", {}).get(entry, {})
        entries[entry] = {
            "reason": old.get("reason", "pinned by python -m bcg_tpu_torch.tools."
                              "census_gate; justify intentional kernel-count changes here"),
            "counts": flat_counts(recorded, backend),
        }
        if old.get("bands"):
            entries[entry]["bands"] = old["bands"]
    section = {"backend": backend, "torch_version": _torch_version(), "entries": entries}
    if layers is not None:
        section["layers"] = layers
    return section


def update_baseline(census: Dict[str, Dict], path: Optional[str] = None) -> str:
    """Rewrite the ``cpu`` section from a CPU census, keeping reasons."""
    path = path or BASELINE
    data = load_baseline(path) or {}
    data["cpu"] = _section(census, "cpu", data.get("cpu", {}))
    return _write(data, path)


def update_cuda(saved: Dict, path: Optional[str] = None) -> str:
    """Rewrite the ``cuda`` section from a census saved on the card
    (``{"layers": N, "entries": {entry: census}}``), keeping reasons and
    bands."""
    path = path or BASELINE
    data = load_baseline(path) or {}
    section = _section(saved["entries"], "cuda", data.get("cuda", {}), layers=saved["layers"])
    section["torch_version"] = saved.get("torch_version", section["torch_version"])
    data["cuda"] = section
    return _write(data, path)


def render_table(census: Dict[str, Dict]) -> str:
    lines = []
    for entry, rec in sorted(census.items()):
        if "error" in rec:
            lines.append(f"{entry}: census failed: {rec['error']}")
            continue
        counts = flat_counts(rec, "cuda" if rec.get("backend") == "cuda" else "cpu")
        lines.append(f"{entry} ({rec.get('backend')}): "
                     + ", ".join(f"{k} {v}" for k, v in sorted(counts.items())))
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="The port's per-decode-step launch census and its drift gate.")
    parser.add_argument("--check", action="store_true",
                        help="compare with the cpu section of census_baseline.json; "
                        "rc 2 on drift")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the cpu section (keeps reasons)")
    parser.add_argument("--update-cuda", metavar="CENSUS_JSON",
                        help="rewrite the cuda section from a census saved on the card")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="print the census as JSON")
    parser.add_argument("--arms", default=",".join(ARMS),
                        help=f"decode-loop families to exercise ({','.join(ARMS)})")
    args = parser.parse_args(argv)

    if args.update_cuda:
        with open(args.update_cuda) as f:
            print(f"baseline written: {update_cuda(json.load(f))}", file=sys.stderr)
        return 0
    arms = tuple(a for a in args.arms.split(",") if a)
    bad = [a for a in arms if a not in ARMS]
    if bad:
        print(f"unknown arms {bad}; known: {ARMS}", file=sys.stderr)
        return 1
    census = run_scenario(arms)
    print(json.dumps(census, indent=2, sort_keys=True) if args.as_json
          else render_table(census))
    if args.update_baseline:
        print(f"baseline written: {update_baseline(census)}", file=sys.stderr)
        return 0
    if args.check:
        findings = check_drift(census, load_baseline(), "cpu")
        for f in findings:
            print(f"DRIFT: {f}", file=sys.stderr)
        if findings:
            return 2
        print("census matches baseline", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
