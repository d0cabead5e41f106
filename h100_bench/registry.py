"""Finds a cell's parts by name, as files of their own.

``BENCHMARK.json`` (at the checkout's root) names each cell's
configuration and traffic mix and lists the metrics.  A configuration
``<c>`` is ``configs/<c>.json``, a traffic mix ``<t>`` is
``traffic/<t>.json`` and a metric ``<m>`` is ``metrics/<m>.py``, all under
this folder (or under the extra folders a test passes).  A new cell,
configuration, traffic mix or metric is therefore new files and entries,
never an edit of an existing file.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")


@dataclass
class Cell:
    name: str
    config: Dict
    traffic: Dict
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


class Registry:
    def __init__(self, benchmark: str = BENCHMARK, extra_dirs: Sequence[str] = ()):
        with open(benchmark) as f:
            self.bench = json.load(f)
        self.dirs = [HERE, *extra_dirs]

    def _find(self, sub: str, name: str, ext: str) -> str:
        if not name or "/" in name or name.startswith("."):
            raise ValueError(f"bad name {name!r}")
        for d in self.dirs:
            path = os.path.join(d, sub, name + ext)
            if os.path.exists(path):
                return path
        raise FileNotFoundError(f"no {sub}/{name}{ext} under {self.dirs}")

    def config(self, name: str) -> Dict:
        with open(self._find("configs", name, ".json")) as f:
            return json.load(f)

    def traffic(self, name: str) -> Dict:
        from h100_bench.traffic import check_traffic

        with open(self._find("traffic", name, ".json")) as f:
            return check_traffic(json.load(f))

    def metric(self, name: str) -> ModuleType:
        path = self._find("metrics", name, ".py")
        spec = importlib.util.spec_from_file_location(
            "h100_bench_metric_" + name.replace("-", "_").replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for attr in ("UNIT", "BETTER", "SOURCE", "read"):
            if not hasattr(mod, attr):
                raise AttributeError(f"metric {name}: {path} lacks {attr}")
        return mod

    @staticmethod
    def _applies(metric: Dict, cell: str) -> bool:
        return "workloads" not in metric or cell in metric["workloads"]

    def cell(self, name: str) -> Cell:
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        if not any(c["name"] == entry["config"] for c in self.bench["configs"]):
            raise KeyError(f"workload {name!r} names an unlisted config {entry['config']!r}")
        return Cell(
            name=name, config=self.config(entry["config"]), traffic=self.traffic(entry["traffic"]),
            chips=int(entry["chips"]),
            end_to_end=[m for m in self.bench["end_to_end"] if self._applies(m, name)],
            per_layer=[m for m in self.bench["per_layer"] if self._applies(m, name)],
        )

    def metrics(self, entries: Sequence[Dict]) -> Dict[str, ModuleType]:
        """Each listed metric's reader, its unit and direction held to the
        entry's."""
        out = {}
        for m in entries:
            mod = self.metric(m["name"])
            if mod.UNIT != m["unit"] or mod.BETTER != m["better"] or mod.SOURCE != m["source"]:
                raise ValueError(f"metric {m['name']}: file says {mod.UNIT}/{mod.BETTER}/"
                                 f"{mod.SOURCE}, BENCHMARK.json {m['unit']}/{m['better']}/"
                                 f"{m['source']}")
            out[m["name"]] = mod
        return out

