"""The perf gate's banded baseline, framework-free: the comparison half of
``scripts/perf_gate.py`` (its ``load_baseline``, ``_bounds``,
``check_metrics``, ``check_stale`` and ``update_baseline``), reading the
port's own file, ``bcg_tpu_torch/tools/perf_baseline.json``.

Each entry is ``{value, op: min|max|range, tol_rel, tol_abs, reason}``:
the slack is ``|value| * tol_rel + tol_abs``, and ``op`` says which side
of the value it opens (``min``: at least value - slack; ``max``: at most
value + slack; ``range``: within both).  The baseline is load-bearing,
as ``lint_baseline.json`` is: a measured metric with no entry is a
finding (deleting an entry resurfaces its check rather than silencing
it), and so is an entry its scenario ran without measuring (stale).
:func:`update_baseline` rewrites the values and keeps every entry's
reason and band.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional

BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perf_baseline.json")

_COMMENT = (
    "The port's hermetic perf-gate baseline (python -m "
    "bcg_tpu_torch.tools.perf_gate). Every gated metric needs an entry "
    "with a reason; bounds are op (min/max/range) with tol_rel/tol_abs "
    "slack. A measured metric with no entry and an entry nothing measured "
    "are both gate findings. A reason that begins 'differs from the JAX "
    "package:' says why the port's value misses the same-named entry of "
    "the JAX package's perf_baseline.json."
)


def load_baseline(path: Optional[str] = None) -> Optional[Dict]:
    path = path or BASELINE
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _slack(entry: Dict) -> float:
    return (abs(float(entry["value"])) * float(entry.get("tol_rel", 0.0))
            + float(entry.get("tol_abs", 0.0)))


def _bounds(entry: Dict) -> str:
    op = entry.get("op", "range")
    value = float(entry["value"])
    slack = _slack(entry)
    if op == "min":
        return f">= {value - slack:.4g}"
    if op == "max":
        return f"<= {value + slack:.4g}"
    return f"within [{value - slack:.4g}, {value + slack:.4g}]"


def passes(got: float, entry: Dict) -> bool:
    """Whether ``got`` lies inside ``entry``'s band."""
    op = entry.get("op", "range")
    value = float(entry["value"])
    slack = _slack(entry)
    if op == "min":
        return got >= value - slack
    if op == "max":
        return got <= value + slack
    return value - slack <= got <= value + slack


def check_metrics(measured: Dict[str, float], baseline: Optional[Dict]) -> List[str]:
    """Findings (empty = green): the banded comparison, plus a finding for
    every measured metric with no entry."""
    if baseline is None:
        return [f"no baseline file at {BASELINE} — run "
                "python -m bcg_tpu_torch.tools.perf_gate --update-baseline"]
    entries = baseline.get("metrics", {})
    findings: List[str] = []
    for name, got in sorted(measured.items()):
        entry = entries.get(name)
        if entry is None:
            findings.append(
                f"{name}: measured {got:.4g} but metric has no entry in "
                f"{os.path.basename(BASELINE)} — every gated metric needs a justified "
                "baseline (run --update-baseline and add a reason)"
            )
            continue
        if not passes(got, entry):
            findings.append(
                f"{name}: measured {got:.4g}, required {_bounds(entry)} "
                f"(baseline {float(entry['value']):.4g}, "
                f"tol_rel={float(entry.get('tol_rel', 0.0))}, "
                f"tol_abs={float(entry.get('tol_abs', 0.0))}) — "
                f"{entry.get('reason', 'no reason')}"
            )
    return findings


def check_stale(measured: Dict[str, float], baseline: Optional[Dict],
                scenarios: Iterable[str]) -> List[str]:
    """Entries whose scenario ran but which nothing measured (a renamed or
    dropped metric); a scenario that did not run leaves its entries
    alone."""
    if baseline is None:
        return []
    prefixes = tuple(f"{s}." for s in scenarios)
    return [
        f"{os.path.basename(BASELINE)} entry {name!r} was not produced by its scenario "
        "(stale — remove it, or restore the metric)"
        for name in sorted(baseline.get("metrics", {}))
        if name.startswith(prefixes) and name not in measured
    ]


def update_baseline(measured: Dict[str, float], path: Optional[str] = None) -> str:
    """Write ``measured`` as the baseline's values; an entry keeps its
    op, band and reason, a new one gets a range of 15% and a reason that
    asks for one.  Entries of scenarios that did not run stay as they
    were."""
    path = path or BASELINE
    prior = (load_baseline(path) or {}).get("metrics", {})
    metrics = {}
    for name, got in sorted(measured.items()):
        old = prior.get(name, {})
        metrics[name] = {
            # Unrounded: a ratio pinned exactly (11/3) must still pass.
            "value": float(got),
            "op": old.get("op", "range"),
            "tol_rel": old.get("tol_rel", 0.15),
            "tol_abs": old.get("tol_abs", 0.0),
            "reason": old.get(
                "reason",
                "pinned by python -m bcg_tpu_torch.tools.perf_gate "
                "--update-baseline; justify intentional perf changes here",
            ),
        }
    for name, entry in prior.items():
        metrics.setdefault(name, entry)
    with open(path, "w") as f:
        json.dump({"_comment": _COMMENT, "metrics": dict(sorted(metrics.items()))}, f,
                  indent=2, ensure_ascii=False)
        f.write("\n")
    return path
