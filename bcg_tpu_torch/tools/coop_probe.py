"""The rank probe and the exchange check that hold a cooperative sweep
(the sweep's single-job mode over a world of ranks, as
``tools/scale_sweep`` runs it), for the tests and the card script.

* :func:`probe` — a ``scale_sweep`` hook (``hook(run, out_dir)``): around
  the rank's sweep it records every engine call the rank makes (method,
  rows, a digest of the prompts and settings), the game (decisions and
  votes by round, the statistics, and a digest of the three), the
  engine's rows and failed rows, the world's collectives by kind, its
  weights' checksum (:func:`part_checksums`, digested) and bytes, and on CUDA the peak of
  ``torch.cuda.max_memory_allocated`` from the engine's boot until its
  weights are made (before any KV cache) beside
  ``loader.boot_peak_report``'s ``peak_bytes_per_device`` for the same
  preset and mesh.  It writes them to ``probe-r<rank>.json`` in the sweep
  directory.  Every rank of one game must read the same dispatches, game
  digest and weights checksum.
* :func:`exchange_mismatches` — rank 0's ``deliveries`` game events
  against the dense ``parallel.game_step.masked_exchange`` over each
  round's recorded proposals (the probe's) and the game's topology.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Tuple


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True, default=str).encode()).hexdigest()


def part_checksums(params, chunk: int = 1 << 26) -> Dict[str, List[int]]:
    """Per leaf part (``name`` or ``name.part``), an exact checksum of its
    bytes in logical order: the sum of the bytes and the sum weighted by
    position, in int64 on the tensors' device (the card's weights never
    cross to the host)."""
    import torch

    out = {}
    for name, leaf in params.items():
        for part, t in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
            flat = t.contiguous().view(torch.uint8).flatten()
            total = weighted = 0
            for i in range(0, flat.numel(), chunk):
                b = flat[i:i + chunk].to(torch.int64)
                w = (torch.arange(i, i + b.numel(), device=b.device, dtype=torch.int64)
                     % 65521 + 1)
                total += int(b.sum())
                weighted += int((b * w).sum())
            out[name if part is None else f"{name}.{part}"] = [total, weighted]
    return out


def probe(run: Callable[[], Dict[str, Any]], out_dir: str) -> Dict[str, Any]:
    """Run the rank's sweep (``run()``) under the probe; returns its
    summary.  See the module docstring for what is recorded."""
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import boot_peak_report
    from bcg_tpu_torch.obs import counters as obs_counters, fleet
    from bcg_tpu_torch.parallel.sharding import tree_bytes_per_device
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    rec: Dict[str, Any] = {"dispatches": [], "boot": None, "weights": None}
    engines: List[Any] = []
    sims: List[Any] = []
    votes: List[Tuple[int, Dict]] = []
    saved = []

    def patch(cls, name, make):
        orig = getattr(cls, name)
        saved.append((cls, name, orig))
        setattr(cls, name, make(orig))

    def engine_init(orig):
        def init(self, *a, **kw):
            engines.append(self)
            return orig(self, *a, **kw)
        return init

    def load_params(orig):
        def load(self, params):
            cuda = self.device.type == "cuda"
            if cuda:
                torch.cuda.synchronize(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
                base = torch.cuda.memory_allocated(self.device)
            out = orig(self, params)
            if cuda:
                torch.cuda.synchronize(self.device)
                report = boot_peak_report(spec_for_model(self.config.model_name), self.mesh,
                                          self.quantization)
                rec["boot"] = dict(peak_bytes=torch.cuda.max_memory_allocated(self.device),
                                   base_bytes=base,
                                   predicted_bytes=report["peak_bytes_per_device"],
                                   final_bytes=report["final_bytes_per_device"])
            rec["weights"] = dict(checksum=_digest(part_checksums(out)),
                                  bytes=tree_bytes_per_device(out))
            return out
        return load

    def engine_call(method):
        def make(orig):
            def call(self, prompts, *a, **kw):
                rec["dispatches"].append([method, len(prompts), _digest([prompts, a, kw])])
                return orig(self, prompts, *a, **kw)
            return call
        return make

    def sim_init(orig):
        def init(self, *a, **kw):
            sims.append(self)
            return orig(self, *a, **kw)
        return init

    def advance(orig):
        def adv(self, round_num, agent_votes):
            votes.append((round_num, dict(agent_votes)))
            return orig(self, round_num, agent_votes)
        return adv

    patch(TorchEngine, "__init__", engine_init)
    patch(TorchEngine, "_load_params", load_params)
    patch(TorchEngine, "batch_generate_json", engine_call("batch_generate_json"))
    patch(TorchEngine, "batch_generate", engine_call("batch_generate"))
    patch(BCGSimulation, "__init__", sim_init)
    patch(BCGSimulation, "_advance_and_record", advance)
    before = obs_counters.snapshot()
    try:
        summary = run()
    finally:
        for cls, name, orig in reversed(saved):
            setattr(cls, name, orig)
    moved = obs_counters.delta(before)
    game = None
    if sims:
        g = sims[-1].game
        game = dict(decisions=[(r.round_num, dict(r.agent_values)) for r in g.rounds],
                    votes=votes, stats=g.get_statistics())
        game = json.loads(json.dumps(game, sort_keys=True, default=str))
    rec.update(
        rank=fleet.process_index(), world=fleet.process_count(), game=game,
        game_digest=_digest(game),
        rows=sum(e.total_rows for e in engines), failed_rows=sum(e.failed_rows for e in engines),
        collectives={k.rsplit(".", 1)[1]: v for k, v in moved.items()
                     if k.startswith("engine.collective.")},
        summary=summary)
    with open(os.path.join(out_dir, f"probe-r{rec['rank']}.json"), "w") as f:
        json.dump(rec, f, default=str)
    return summary


def read_probes(out_dir: str) -> List[Dict[str, Any]]:
    """Every rank's probe record, by rank."""
    recs = []
    for path in glob.glob(os.path.join(out_dir, "probe-r*.json")):
        with open(path) as f:
            recs.append(json.load(f))
    return sorted(recs, key=lambda r: r["rank"])


def exchange_mismatches(events_path: str, decisions) -> Tuple[int, int, int]:
    """Rank 0's recorded deliveries against the dense exchange:
    ``(rounds checked, receivers checked, receivers whose senders or
    values differ)``.  ``decisions``: the probe's ``game["decisions"]``,
    each round's proposals by agent (the game's record; ``None``:
    abstain).  Receivers and senders go in sorted agent order, as the
    orchestrator's exchange orders them."""
    import torch

    from bcg_tpu_torch.config import NetworkConfig
    from bcg_tpu_torch.parallel.game_step import masked_exchange
    from bcg_tpu_torch.runtime.orchestrator import build_topology

    start, deliveries = None, {}
    with open(events_path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("event") == "game_start":
                start = r
            elif r.get("event") == "deliveries":
                deliveries.setdefault(r["round"], {})[r["agent"]] = (r["senders"],
                                                                    r.get("values"))
    if start is None:
        raise ValueError(f"{events_path}: no game_start record")
    n = start["num_honest"] + start["num_byzantine"]
    lo = start["value_range"][0]
    topo = build_topology(n, NetworkConfig(topology_type=start["topology"]))
    mask = torch.as_tensor(topo.neighbor_mask().T.copy())
    proposals = {int(rnd): props for rnd, props in decisions}
    rounds = receivers = bad = 0
    for rnd, got in sorted(deliveries.items()):
        props = proposals[rnd]
        ids = sorted(props)
        values = torch.tensor([props[a] - lo if props[a] is not None else -1 for a in ids],
                              dtype=torch.int32)
        received, _ = masked_exchange(values, mask)
        rounds += 1
        for i, aid in enumerate(ids):
            cols = [j for j in range(n) if received[i, j] >= 0]
            senders, vals = got.get(aid, (None, None))
            receivers += 1
            bad += int(senders != [ids[j] for j in cols]
                       or vals != [int(received[i, j]) + lo for j in cols])
    return rounds, receivers, bad
