"""The one-rank engine's own spread: the floor under ``chip_smoke.py``'s
mesh paths' (P14, P15) logits limit.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.mesh_floor

Makes ``bcg-tpu/bench-8b``'s random weights on the card (seed 0, as
``chip_smoke.py`` does), keeps ``--depth`` of 36 layers (default the mesh
paths' ``chip_smoke.MESH_DEPTH``), and plays P14's reference
round on the default one-rank engine: one greedy round of the 8 honest +
2 Byzantine game, its tokens and the logits of the sampler calls that P14
holds kept (``chip_smoke.TeacherForcing``).  Then the same round twice
more on fresh engines, fed those tokens as P14's arms are: ``rerun``, the
engine as it is (its determinism), and ``split``, B3a's split planned as
for half the kv heads (one device, nothing changed but the order of the
attention's sums).  Prints the card's name and power limit and one JSON
line a replay: the relative L2 a row of each held call's logits against
the reference's (by ``loop.step``), the largest, and the live rows whose
own greedy token differed (``flips``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--depth", type=int, default=None,
                        help="layers kept (default: chip_smoke.MESH_DEPTH, the mesh paths')")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_floor: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs

    args.depth = args.depth or cs.MESH_DEPTH
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params
    from bcg_tpu_torch.ops import decode_attention as da
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), flush=True)
    cs.phase_build()
    gen = torch.Generator(device=cs.DEVICE)
    gen.manual_seed(0)
    spec, params = cs.cut_depth(init_params(spec_for_model(cs.MODEL), gen, cs.DEVICE),
                                args.depth)
    cfg = cs.game_config(1, greedy=True)
    split_for = da._split_for

    def play(forced=None):
        engine = TorchEngine(cfg.engine, device=cs.DEVICE, params=params, spec=spec)
        rec = cs.TeacherForcing(forced)
        try:
            stats, decisions, votes = cs.play_recorded(BCGSimulation(cfg, engine=engine))
        finally:
            rec.restore()
            engine.shutdown()
        game = json.loads(json.dumps(dict(stats=stats, decisions=decisions, votes=votes),
                                     sort_keys=True, default=str))
        return rec, game

    def half_heads_split(q, Hkv, S, M, kernel="decode_attention", plan=None):
        return split_for(q, max(1, Hkv // 2), S, M, kernel, plan)

    ref, ref_game = play()
    for name in ("rerun", "split"):
        if name == "split":
            da._split_for = half_heads_split
        try:
            rec, game = play(ref.tokens)
        finally:
            da._split_for = split_for
        by_step = {f"{loop}.{step}": cs._rel_rows(logits, ref.logits[loop][step])
                   for loop, steps in enumerate(rec.logits) for step, logits in steps.items()}
        print(f"mesh_floor {name}: " + json.dumps(dict(
            model=cs.MODEL, layers=args.depth, rel_l2=max(by_step.values()),
            rel_l2_by_step=by_step, flips=rec.flips, game_equal=game == ref_game,
            sampler_calls=[len(loop) for loop in rec.tokens])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
