"""The five report scripts over one port run's files, and the headline
figures read back from what they print.

    python -m bcg_tpu_torch.tools.reports [--events EVENTS.jsonl]
        [--trace TRACE.json] [--compile CAUSES.jsonl] [--shards DIR]
        [--alerts ALERTS.jsonl]

Each script under ``scripts/`` is stdlib-only and runs as its own process
(``sys.executable scripts/<name>.py ...``) over the file the port's sink
wrote:

* ``consensus_report.py EVENTS --rounds`` (``BCG_TPU_GAME_EVENTS``);
* ``trace_report.py TRACE`` (``BCG_TPU_TRACE_OUT``: spans, host syncs,
  the census gauges, the ledger, compile counters);
* ``compile_report.py TRACE --events CAUSES`` (the trace's counters and
  the ``BCG_TPU_COMPILE_OBS`` cause stream);
* ``fleet_report.py DIR`` (``BCG_TPU_METRICS_SHARD_DIR``);
* ``alert_report.py ALERTS`` (``BCG_TPU_ALERT_EVENTS``).

Prints one JSON line: each script's exit code and :func:`headline`
figures.  Exits 1 if any script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Any, Dict, List, Optional

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def commands(events: Optional[str] = None, trace: Optional[str] = None,
             compile_events: Optional[str] = None, shards: Optional[str] = None,
             alerts: Optional[str] = None) -> Dict[str, List[str]]:
    """Script name -> its arguments, for the files given."""
    out: Dict[str, List[str]] = {}
    if events:
        out["consensus_report"] = [events, "--rounds"]
    if trace:
        out["trace_report"] = [trace]
        out["compile_report"] = [trace] + (["--events", compile_events]
                                           if compile_events else [])
    if shards:
        out["fleet_report"] = [shards]
    if alerts:
        out["alert_report"] = [alerts]
    return out


def run(name: str, args: List[str], timeout: float = 120) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", f"{name}.py")]
                          + args, capture_output=True, text=True, timeout=timeout)


def _table(text: str, title: str) -> List[List[str]]:
    """The whitespace-split rows of the table under ``== <title>``
    (header included), up to the next blank line."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        if line.startswith("== " + title):
            rows = []
            for row in lines[i + 1:]:
                if not row.strip():
                    break
                rows.append(row.split())
            return rows
    return []


def headline(name: str, out: str) -> Dict[str, Any]:
    """The figures a report's output carries that a run can be held to."""
    figures: Dict[str, Any] = {}
    if name == "consensus_report":
        rows = _table(out, "consensus outcomes by config")
        if rows:
            col = rows[0].index("games")
            figures["games"] = sum(int(r[col]) for r in rows[1:])
        m = re.search(r"round duration: (\d+) rounds", out)
        figures["rounds"] = int(m.group(1)) if m else None
    elif name == "trace_report":
        m = re.search(r"total (\d+) sync\(s\), (\d+) attributed", out)
        figures["host_syncs"] = int(m.group(1)) if m else None
        figures["host_syncs_attributed"] = int(m.group(2)) if m else None
        rows = _table(out, "hlo kernel census")
        census = {}
        if rows:
            header = rows[0][2:]   # "jit entry" is two words
            for row in rows[1:]:
                census[row[0]] = {c: (None if v == "-" else int(v))
                                  for c, v in zip(header, row[1:])}
        figures["census"] = census
        figures["spans"] = [r[0] for r in _table(out, "span latency")[1:]]
    elif name == "compile_report":
        rows = _table(out, "compile time by entry")
        figures["entries"] = {r[0]: {"compiles": int(r[1]), "retraces": int(r[2])}
                              for r in rows[1:]}
        figures["cause_entries"] = sorted(set(re.findall(r"x  (\w+): ", out)))
        m = re.search(r"(\d+) trace-cache entr", out)
        figures["cache_entries"] = int(m.group(1)) if m else None
    elif name == "fleet_report":
        figures["runs"] = {run_id: int(n) for run_id, n in
                           re.findall(r"== run (\S+): (\d+) rank\(s\)", out)}
    elif name == "alert_report":
        pairs = re.findall(r"(\d+) fired / (\d+) resolved", out)
        figures["fired"] = sum(int(f) for f, _ in pairs)
        figures["resolved"] = sum(int(r) for _, r in pairs)
        figures["rules"] = sorted(set(re.findall(r"\] (\w+): \d+ fired", out)))
    return figures


def run_all(timeout: float = 120, **files) -> Dict[str, Dict[str, Any]]:
    """Run every script the files allow: name -> rc, figures, and the
    output's last lines on a failure."""
    results = {}
    for name, args in commands(**files).items():
        proc = run(name, args, timeout=timeout)
        rec: Dict[str, Any] = {"rc": proc.returncode, **headline(name, proc.stdout)}
        if proc.returncode:
            rec["stderr"] = proc.stderr.strip()[-500:]
        results[name] = rec
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--events")
    parser.add_argument("--trace")
    parser.add_argument("--compile", dest="compile_events")
    parser.add_argument("--shards")
    parser.add_argument("--alerts")
    args = parser.parse_args(argv)
    results = run_all(events=args.events, trace=args.trace,
                      compile_events=args.compile_events, shards=args.shards,
                      alerts=args.alerts)
    print(json.dumps(results))
    return 1 if any(r["rc"] for r in results.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
