"""Chip smoke test of the PyTorch/H100 port (``bcg_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero; nothing is skipped):

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the served path from ``bcg_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and prints each kernel's
   register / shared-memory report.
3. Reference check on a small input: ``bcg-tpu/tiny-dh128`` logits of a
   prefill plus 8 decode steps, bf16 through the kernels on the card,
   against the same weights in f32 through the plain versions on the CPU.
4. Game: a full 8 honest + 2 Byzantine game, 3 rounds, on
   ``bcg-tpu/bench-8b`` (Qwen3-8B widths, 36 layers, random weights made
   on the card from a seed), through ``BCGSimulation(config,
   engine=TorchEngine(...))``, timed with nothing wrapped.  Every
   kernel's launch count is set to 0 just before and read just after;
   each must be > 0.
5. Profile: the game's first round again (greedy, prefixes cached),
   timed once and once under ``torch.profiler``: device time by kernel
   and by kind, and the device's busy share of the round's wall time.
6. Capture: the 3-round game again, untimed, with each kernel launcher
   wrapped to keep a device copy of the inputs of its largest call, with
   their strides (k/v are views into the KV cache).
7. Kernel phase: each kernel against its plain PyTorch version on those
   inputs (the sampler also on mixed greedy / sampled rows at top_p 1.0
   and 0.9), with CUDA-event timings of the kernel, the plain version and,
   where one PyTorch call computes the same function, that call; and the
   bound (bytes at 3.35 TB/s or operations at 989 TFLOP/s).  Attention
   errors are held relative to the reference's own size, and the same
   measure is printed for the plain version with one tile of 64 live
   keys dropped, the size of error the limits must catch.
8. Prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
   line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# bf16 attention, kernel vs plain version.  Both round p to bf16 (the
# kernel unnormalised, the plain version normalised) and round the output
# to bf16: relative noise of a few 2**-9.  Errors are measured relative to
# the reference itself, as the L2 norm of (kernel - plain) over the
# reference's L2 norm: per query row and head (over Dh), and per batch row
# and head (over T and Dh).  On an H100 at the game's inputs the kernels
# read at most 0.0039 per row and 0.0021 per head, and the plain version
# with 64 of several thousand live keys dropped reads 0.33 / 0.034 (flash
# prefill) and 0.050 / 0.050 (decode): the limits sit about 5x above the
# first and at least 2.5x under the second.
ATTN_REL_ROW_TOL = 2e-2
ATTN_REL_HEAD_TOL = 1e-2
DROP_KEYS = 64
SMALL_REF_TOL = 0.15           # tiny-dh128 logits, bf16 on the card vs f32 on the CPU
                               # after 2 layers and 8 decode steps (logits are O(3))


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------------- capture

def keep(a):
    """A device copy of ``a`` with its strides (a KV-cache view keeps the
    full cache's batch stride, as the kernels read it in the game)."""
    import torch

    if not torch.is_tensor(a):
        return a
    out = torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device=a.device)
    return out.copy_(a)


class Capture:
    """Wraps each kernel launcher to keep a device copy (``keep``) of the
    inputs of its largest call: the shapes and data the served path gives
    it.  Only a call strictly larger than the kept one is copied."""

    def __init__(self):
        from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler

        self.mods = {
            "flash_prefill": (attention, "flash_attention_cuda"),
            "decode_attention": (decode_attention, "decode_attention_cuda"),
            "guided_sampler": (guided_sampler, "sample_rows_cuda"),
        }
        self.best = {}
        self.orig = {}
        for name, (mod, fn) in self.mods.items():
            orig = getattr(mod, fn)
            self.orig[name] = orig
            setattr(mod, fn, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def wrapped(*args):
            size = sum(a.numel() for a in args if hasattr(a, "numel"))
            if size > self.best.get(name, (0, None))[0]:
                self.best[name] = (size, tuple(keep(a) for a in args))
            return orig(*args)
        return wrapped

    def restore(self):
        for name, (mod, fn) in self.mods.items():
            setattr(mod, fn, self.orig[name])


def launch_counts():
    from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler

    return {
        "flash_prefill": attention.flash_attention.launches,
        "decode_attention": decode_attention.decode_attention.launches,
        "guided_sampler": guided_sampler.sample_rows.launches,
    }


def zero_counts():
    from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler

    attention.flash_attention.launches = 0
    decode_attention.decode_attention.launches = 0
    guided_sampler.sample_rows.launches = 0


# ---------------------------------------------------------------- phases

def phase_build():
    from bcg_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    secs = time.perf_counter() - t0
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with open(os.path.join(_build.BUILD_DIR, "build.log"), "w") as f:
        f.write("\n".join(logs))
    for log in logs:
        for line in log.splitlines():
            if line.startswith("==") or "registers" in line or "spill" in line:
                print(f"build: {line.strip()}")
    print(f"build: {len(logs)} libraries compiled in {secs:.1f} s", flush=True)


def phase_small_reference(dev: str = "cuda"):
    """tiny-dh128: kernels on the card (bf16) vs plain versions on the CPU
    (f32), prefill + 8 decode steps."""
    import numpy as np
    import torch

    from bcg_tpu_torch.models import transformer as tt
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params

    spec = spec_for_model("bcg-tpu/tiny-dh128")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    p32 = init_params(spec, gen, "cpu", torch.float32)
    p16 = {k: v.to(dev, torch.bfloat16) for k, v in p32.items()}
    rng = np.random.RandomState(0)
    B, L, S = 3, 150, 160
    tokens = torch.as_tensor(rng.randint(0, 256, (B, L)))
    valid = torch.ones((B, L), dtype=torch.bool)
    valid[0, :37] = False
    valid[2, :90] = False

    def run(params, dev):
        cache = tt.init_kv_cache(spec, B, S, torch.bfloat16, dev)
        logits, cache = tt.prefill(params, spec, tokens.to(dev), valid.to(dev), cache)
        outs = [logits.float().cpu()]
        vm = torch.zeros((B, S), dtype=torch.bool, device=dev)
        vm[:, :L] = valid.to(dev)
        lens = valid.sum(1).to(torch.int32).to(dev)
        tok = torch.as_tensor(rng_tok, device=dev)
        for i in range(8):
            vm[:, L + i] = True
            logits, cache = tt.decode_step(params, spec, tok[:, i], L + i, lens + i, cache, vm)
            outs.append(logits.float().cpu())
        return torch.stack(outs)

    rng_tok = rng.randint(0, 256, (B, 8))
    ref = run(p32, "cpu")
    got = run(p16, dev)
    if not torch.isfinite(got).all():
        fail("small reference: non-finite logits from the kernels")
    err = (got - ref).abs().max().item()
    print(f"small reference: tiny-dh128 prefill + 8 decode logits, card bf16 vs CPU f32: "
          f"max_abs_err={err:.4g} tol={SMALL_REF_TOL}", flush=True)
    if err > SMALL_REF_TOL:
        fail(f"small reference error {err} > {SMALL_REF_TOL}")


def game_config(max_rounds: int, greedy: bool = False):
    from bcg_tpu_torch.config import (BCGConfig, EngineConfig, GameConfig, LLMConfig,
                                      MetricsConfig)

    llm = LLMConfig(temperature_decide=0.0, temperature_vote=0.0) if greedy else LLMConfig()
    return BCGConfig(
        game=GameConfig(num_honest=8, num_byzantine=2, max_rounds=max_rounds, seed=0),
        engine=EngineConfig(backend="torch", model_name="bcg-tpu/bench-8b"),
        llm=llm,
        metrics=MetricsConfig(save_results=False),
    )


# Kernel name fragments -> kind, for the profile's breakdown (cuBLAS's
# matrix products show up as nvjet / gemm / gemv kernels).
KINDS = (
    ("flash_prefill_kernel", "flash_prefill"),
    ("decode_attention_kernel", "decode_attention"),
    ("guided_sampler_kernel", "guided_sampler"),
    ("nvjet", "matmul"), ("gemm", "matmul"), ("gemv", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"),
)


def phase_profile(engine):
    """The game's first round again, greedy, played twice on the booted
    engine — every prompt prefix is already cached, so both runs do the
    same work: once timed, once under ``torch.profiler`` (device activity
    only).  Prints device milliseconds by kernel kind, the top kernels,
    and the device's busy share: the profiled device time over the timed
    run's wall time (the profiler's own overhead slows the profiled run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    def play():
        sim = BCGSimulation(game_config(max_rounds=1, greedy=True), engine=engine)
        steps0 = engine.total_decode_steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, engine.total_decode_steps - steps0

    wall_ms, steps = play()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_ms, profiled_steps = play()
    rows = []
    for evt in prof.key_averages():
        ms = getattr(evt, "device_time_total", 0.0) / 1e3
        if ms > 0:
            rows.append((ms, evt.count, evt.key))
    rows.sort(reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    kinds = {}
    for ms, _, key in rows:
        kind = next((k for frag, k in KINDS if frag in key.lower()), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print("profile: " + json.dumps({
        "round_wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
        "decode_steps": [steps, profiled_steps], "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if rows else None,
        "by_kind_ms": kinds,
        "top": [{"kernel": key[:90], "ms": ms, "count": n} for ms, n, key in rows[:8]],
    }), flush=True)


def phase_game():
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    cfg = game_config(max_rounds=3)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg.engine, device="cuda")
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    sim = BCGSimulation(cfg, engine=engine)
    stats = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    decisions = sim.profiler.decisions
    line = {
        "rounds": stats["total_rounds"],
        "termination_reason": stats.get("termination_reason"),
        "agent_decisions_per_sec": decisions / wall,
        "decisions": decisions,
        "game_seconds": wall,
        "boot_seconds": boot_s,
        "prefill_seconds": engine.prefill_seconds,
        "decode_seconds": engine.decode_seconds,
        "decode_steps": engine.total_decode_steps,
        "failed_rows": engine.failed_rows,
        "total_rows": engine.total_rows,
        "peak_bytes": peak,
        "launches": counts,
    }
    print("game: " + json.dumps(line), flush=True)
    if stats["total_rounds"] < 1 or len(stats) < 40:
        fail(f"game statistics malformed: {sorted(stats)[:5]}...")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was never launched on the game path")
    if engine.failed_rows:
        fail(f"{engine.failed_rows} rows failed to produce schema-valid JSON")
    phase_profile(engine)
    inputs = phase_capture(engine)
    engine.shutdown()
    del engine, sim
    torch.cuda.empty_cache()
    return counts, inputs


def phase_capture(engine):
    """The timed game's configuration again on the booted engine, untimed,
    with every kernel launcher wrapped by ``Capture``.  Returns each
    kernel's largest-call inputs, on the card."""
    import torch

    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    cap = Capture()
    try:
        BCGSimulation(game_config(max_rounds=3), engine=engine).run()
    finally:
        cap.restore()
    torch.cuda.synchronize()
    return {name: args for name, (_, args) in cap.best.items()}


def per_row(fn, *args):
    """Apply ``fn`` row by row (batch axis 0 of every tensor argument):
    the plain attention versions materialise [H, T, S] scores, which at
    game shapes only fit one batch row at a time."""
    import torch

    B = args[0].shape[0]
    outs = []
    for b in range(B):
        outs.append(fn(*[a[b:b + 1] if hasattr(a, "shape") else a for a in args]))
    return torch.cat(outs)


def rel_errors(out, ref, head_dims):
    """Worst relative L2 error of ``out`` against ``ref``: per query row
    and head (over Dh, the last axis) and per batch row and head (over
    ``head_dims``).  A slice whose reference is all zeros (a fully masked
    row) counts as 0 only if ``out`` is zero there too."""
    diff = (out.float() - ref.float()).pow(2)
    ref2 = ref.float().pow(2)

    def worst(dims):
        e, r = diff.sum(dims).sqrt(), ref2.sum(dims).sqrt()
        return (e / r.clamp_min(1e-30)).max().item()

    return worst((-1,)), worst(head_dims)


def drop_live_keys(mask):
    """``mask`` (keys on the last axis) with, per batch row, the middle
    ``DROP_KEYS`` of its live keys turned off."""
    out = mask.clone()
    for b in range(mask.shape[0]):
        live = mask[b].reshape(-1, mask.shape[-1]).any(0).nonzero().flatten()
        mid = len(live) // 2
        out[b, ..., live[mid:mid + DROP_KEYS]] = False
    return out


def attention_check(out, ref, head_dims, dropped_ref):
    """The error fields of an attention kernel's result line."""
    import torch

    rel_row, rel_head = rel_errors(out, ref, head_dims)
    drop_row, drop_head = rel_errors(dropped_ref, ref, head_dims)
    return dict(max_abs_err=(out.float() - ref.float()).abs().max().item(),
                ref_rms=ref.float().pow(2).mean().sqrt().item(),
                ref_max=ref.float().abs().max().item(),
                rel_row=rel_row, rel_head=rel_head,
                dropped_rel_row=drop_row, dropped_rel_head=drop_head,
                ok=rel_row <= ATTN_REL_ROW_TOL and rel_head <= ATTN_REL_HEAD_TOL
                and bool(torch.isfinite(out).all()))


def phase_kernels(inputs, counts):
    import torch
    import torch.nn.functional as F

    from bcg_tpu_torch.ops import attention, decode_attention, guided_sampler

    results = []
    errors = []

    def flash():
        q, k, v, mask, scale = inputs["flash_prefill"]
        out = attention.flash_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = per_row(attention.flash_attention_plain, q, k, v, mask, scale)
        dropped = per_row(attention.flash_attention_plain, q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        del out, ref, dropped
        ms = time_ms(lambda: attention.flash_attention_cuda(q, k, v, mask, scale))
        plain_ms = time_ms(lambda: per_row(attention.flash_attention_plain, q, k, v, mask, scale),
                           reps=3, warmup=1)
        B, T, H, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        group = H // Hkv
        qt, kt, vt = (q.transpose(1, 2), k.transpose(1, 2).repeat_interleave(group, 1),
                      v.transpose(1, 2).repeat_interleave(group, 1))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], scale=scale), reps=5)
        live = mask.sum().item()
        # q, k, v and the mask read once, the output written once (bf16).
        byts = 2 * (2 * q.numel() + k.numel() + v.numel()) + mask.numel()
        bms, by = bound(byts, 4 * Dh * H * live)
        return dict(name="flash_prefill", route="cuda",
                    source="bcg_tpu_torch/csrc/flash_prefill.cu",
                    replaces="bcg_tpu/ops/attention.py:37 _flash_kernel",
                    launches=counts.get("flash_prefill"), **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, shape=[B, T, H, Hkv, S], live_pairs=live)

    def decode():
        q, k, v, mask, scale = inputs["decode_attention"]
        out = decode_attention.decode_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = decode_attention.decode_attention_plain(q, k, v, mask, scale)
        dropped = decode_attention.decode_attention_plain(q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (-1,), dropped)
        ms = time_ms(lambda: decode_attention.decode_attention_cuda(q, k, v, mask, scale), reps=50)
        plain_ms = time_ms(lambda: decode_attention.decode_attention_plain(q, k, v, mask, scale))
        B, H, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        group = H // Hkv
        m2 = mask if mask.dim() == 2 else mask[:, 0]
        kt = k.transpose(1, 2).repeat_interleave(group, 1)
        vt = v.transpose(1, 2).repeat_interleave(group, 1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=m2[:, None, None], scale=scale), reps=50)
        valid = m2.sum().item()
        byts = 2 * (2 * valid * Hkv * Dh) + 2 * 2 * q.numel() + m2.numel()
        bms, by = bound(byts, 4 * Dh * H * valid)
        return dict(name="decode_attention", route="cuda",
                    source="bcg_tpu_torch/csrc/decode_attention.cu",
                    replaces="bcg_tpu/ops/decode_attention.py:57 _decode_kernel",
                    launches=counts.get("decode_attention"), **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, shape=[B, H, Hkv, S], valid_slots=valid)

    def sampler():
        logits, minb, dfa_ids, states, meta_i, meta_f, eos_id, _top_p = inputs["guided_sampler"]
        B, V = logits.shape
        # Mixed rows: even rows greedy, odd rows sampled; the game's own
        # per-row scalars otherwise.
        mi = meta_i.clone()
        mi[:, 2] = (torch.arange(B, device=mi.device) % 2 == 0).to(torch.int32)
        mismatches, err = 0, 0
        for top_p in (1.0, 0.9):
            tk, ak = guided_sampler.sample_rows_cuda(logits, minb, dfa_ids, states, mi,
                                                     meta_f, eos_id, top_p)
            tp, ap = guided_sampler.sample_rows_plain(logits, minb, dfa_ids, states, mi,
                                                      meta_f, eos_id, top_p)
            mismatches += int((tk.long() != tp.long()).sum()) + int((ak != ap).sum())
            err = max(err, int((tk.long() - tp.long()).abs().max()))
        ms = time_ms(lambda: guided_sampler.sample_rows_cuda(
            logits, minb, dfa_ids, states, mi, meta_f, eos_id, 1.0), reps=50)
        plain_ms = time_ms(lambda: guided_sampler.sample_rows_plain(
            logits, minb, dfa_ids, states, mi, meta_f, eos_id, 1.0), reps=5)
        byts = B * V * (4 + 2) + meta_i.numel() * 4 + meta_f.numel() * 4 + B * 8
        bms, by = bound(byts, 0)
        return dict(name="guided_sampler", route="cuda",
                    source="bcg_tpu_torch/csrc/guided_sampler.cu",
                    replaces="bcg_tpu/ops/guided_sampler.py:93 _sampler_kernel",
                    launches=counts.get("guided_sampler"), max_abs_err=float(err),
                    token_mismatches=mismatches, ok=mismatches == 0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None, shape=[B, V])

    for phase in (flash, decode, sampler):
        results.append(phase())
    for r in results:
        if "rel_row" in r:
            err = (f"max_abs_err={r['max_abs_err']:.4g} ref_rms={r['ref_rms']:.4g} "
                   f"ref_max={r['ref_max']:.4g} rel_row={r['rel_row']:.4g} "
                   f"(tol {ATTN_REL_ROW_TOL}) rel_head={r['rel_head']:.4g} "
                   f"(tol {ATTN_REL_HEAD_TOL}) with {DROP_KEYS} live keys dropped: "
                   f"rel_row={r['dropped_rel_row']:.4g} rel_head={r['dropped_rel_head']:.4g}")
        else:
            err = f"token_mismatches={r['token_mismatches']} (tol 0)"
        print(f"kernel {r['name']}: {err} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) launches={r['launches']} "
              f"shape={r['shape']}", flush=True)
        if not r["ok"]:
            errors.append(f"{r['name']}: disagrees with its plain version")
    return results, errors


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        import bcg_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not next to this script: {exc}", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    card = card_line()
    print(card, flush=True)
    phase_build()
    phase_small_reference()
    counts, inputs = phase_game()
    results, errors = phase_kernels(inputs, counts)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results]}), flush=True)
    if errors:
        fail("; ".join(errors))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
