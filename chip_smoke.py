"""Chip smoke test of the PyTorch/H100 port (``bcg_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

What it does, in order (any failure exits non-zero; nothing is skipped):

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every CUDA kernel of the served paths from
   ``bcg_tpu_torch/csrc`` (one ``nvcc`` per source, all at once) and
   prints each kernel's register / shared-memory report.
3. Reference check on a small input: ``bcg-tpu/tiny-dh128`` logits of a
   prefill, 4 decode steps, a fast-forward chunk and a speculative chunk,
   over a dense bf16, int8 and int4 KV cache and a paged bf16, int8 and
   int4 pool (right-padded prefill, shuffled table), bf16 through the kernels
   on the card, against the same weights in f32 through the plain
   versions on the CPU (int4: in bf16, see ``phase_small_reference``);
   then the same with int8 and int4 weights over a bf16 cache (int4
   through B5, held to the CPU run with bf16 leaves).
4. Nine game paths on ``bcg-tpu/bench-8b`` (Qwen3-8B widths, 36 layers,
   random weights made once on the card from a seed and shared by every
   engine through ``TorchEngine(params=...)``), each a full 8 honest + 2
   Byzantine game through ``BCGSimulation(config, engine=TorchEngine(...))``.
   Every kernel's launch count (and the call count of the plain paged
   attention versions) is set to 0 just before a path and read just
   after; each kernel of the path must be > 0, the plain paged calls 0,
   and no row may fail its schema.

   * P1: the default engine (bf16 cache, plain loop), 1 round, timed
     with nothing wrapped, then profiled and captured (5, 6).
   * P2: int8 cache, fast-forward loop, compact JSON, 2 rounds, timed,
     then profiled and captured; its line adds the decode steps per
     decision, their ratio to the steps the plain loop takes for the same
     outputs, and the KV-cache bytes.
   * P3: bf16 cache, speculative loop, 1 round, untimed and captured;
     prints the drafted and accepted counts.
   * P4: int8 cache, plain loop, 1 round, untimed and captured.
   * P5: block-paged KV cache over a bf16 pool, plain loop, 2 rounds
     (round 2's prompts extend round 1's radix chains), timed, then
     profiled and captured.
   * P6: paged int4 pool, fast-forward loop, compact JSON, 1 round,
     untimed and captured.
   * P7: paged int8 pool, speculative loop, 1 round, untimed and
     captured.
   * P8: int8 weights (W8A8), int8 cache, fast-forward loop, compact
     JSON, 1 round, timed, then profiled.
   * P9: int4 weights (W4A16 through B5), bf16 cache, plain loop, 1
     round, timed, then profiled with B5's inputs captured in the
     profiled round.
   P8 and P9 quantize their own copies of the shared bf16 weights.
   The paged paths' lines add the pool's block counts and prefix hit
   rate and the private KV bytes of the largest batch; every line has the
   KV bytes of its largest batch (P1's: the dense cache at the same game).
   The paged pools hold ``PAGED_POOL_BLOCKS`` blocks, less than the auto
   size the line also prints (the whole KV budget of the card, which
   leaves too little for the activations of the other paths' prefills).
5. Profile (P1, P2, P5, P8, P9): the game's first round again (greedy,
   prefixes cached), timed once and once under ``torch.profiler``:
   device time by kernel and by kind, and the device's busy share of the
   round's wall.
6. Capture: the path's game again, untimed (P3, P4, P6, P7: the counted
   run itself; P9: the profiled round, whose wall time the busy share
   does not use, the copies' bytes printed in its profile line), with
   each kernel launcher wrapped to keep a device copy of the inputs of
   its largest call, with their strides (k/v are views into the KV
   cache).
7. Kernel phase: each of the thirteen kernel forms against its plain
   PyTorch version on its captured inputs (the sampler also on mixed
   greedy / sampled rows at top_p 1.0 and 0.9), with CUDA-event timings
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call; and the bound (bytes at 3.35 TB/s, int8
   values and f32 scales counted as stored, or operations at 989
   TFLOP/s).  B5 (the W4A16 matmul) runs at P9's largest call (the LM
   head, M = 10) and at one captured weight of each layer shape with
   M = 1, 10, 50 and 256, held by relative L2 error per output row, with
   ``torch.matmul`` over the already dequantized bf16 weight timed beside
   it (another function: the bf16 product int4 has to beat); its times
   come from CUDA graphs of calls (``graph_ms``).  Attention errors are
   held relative to the reference's own size, and the same measure is
   printed for the plain version with one tile of 64 live keys dropped,
   the size of error the limits must catch.
   The six paged forms (bf16, int8, int4 pools; single step and chunk):
   P5 gives bf16 single-step, P6 int4 chunk and P7 int8 chunk their
   inputs; the other three run on those captured pools and tables (bf16
   chunk with a K = 5 query, int8 and int4 single-step with the chunk's
   first query position).  Each paged form's bound counts the distinct
   pool blocks that some live table entry names, read once; beside its
   time stands the dense kernel's (B3a / B3b) over the gathered dense
   view of the same inputs.  Flash prefill (B1) is also held to its
   plain version at P5's captured right-padded prefill input.
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
                               # after 2 layers and 6 decode steps (logits are O(3))
# tiny-dh128 with int8 weights (W8A8), bf16 on the card vs bf16 on the
# CPU: relative L2 error per logit row, the largest over the rows, for
# each weight draw.  On the CPU alone the bf16 and f32 runs of seeds 7-12
# read 0.048-0.059 (max abs 0.17-0.19), and the faulty control (layer 1's
# w_down scale rolled by one channel) 0.10-0.13 against the bf16 run; a
# rolled scale in layer 0's wq or the LM head reads 0.17-0.37.  The limit
# sits between the two.
INT8_REF_REL_TOL = 0.075
INT8_REF_SEEDS = (7, 8, 9)
# B5 against its plain version: relative L2 error per output row.  Both
# take the same bf16 products and sum them in f32 in another order (~1e-6
# at these depths); a wrong nibble, half or group scale reads O(1).
W4_REL_ROW_TOL = 1e-3
MODEL = "bcg-tpu/bench-8b"
DEVICE = "cuda"
# Blocks of 16 tokens in each paged path's pool: 19.3 GB of bf16, 10.0 GB
# of int8 and 5.0 GB of int4 at bench-8b, room for a 10-row batch at the
# longest window plus two rounds of radix-resident prompts.
PAGED_POOL_BLOCKS = 8192


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


def graph_ms(calls, reps: int = 20) -> float:
    """Device time of one call: ``reps`` calls (``calls[i % len(calls)]``)
    captured in one CUDA graph, the graph replayed and timed with events,
    so a call's host time stays out of a kernel of a few microseconds.
    Passing calls over distinct input copies that together exceed the
    50 MB L2 keeps their weights cold, as a decode step finds them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    del graph
    return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    tb = bytes_moved / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# --------------------------------------------------------------- kernels

# Kernel form -> (ops module attribute, launcher attribute, wrapper
# attribute holding the launch count).
FORMS = {
    "flash_prefill": ("attention", "flash_attention_cuda", "flash_attention"),
    "decode_attention": ("decode_attention", "decode_attention_cuda", "decode_attention"),
    "guided_sampler": ("guided_sampler", "sample_rows_cuda", "sample_rows"),
    "chunk_decode_attention": ("decode_attention", "chunk_decode_attention_cuda",
                               "chunk_decode_attention"),
    "decode_attention_int8": ("decode_attention", "decode_attention_int8_cuda",
                              "decode_attention_int8"),
    "chunk_decode_attention_int8": ("decode_attention", "chunk_decode_attention_int8_cuda",
                                    "chunk_decode_attention_int8"),
}
# The W4A16 matmul (B5): one form, captured per weight shape.
FORMS["w4a16_matmul"] = ("w4_matmul", "w4a16_matmul_cuda", "w4a16_matmul")
# The paged forms: one launcher per form (step / chunk) serves all three
# pool layouts, each counted apart (``launches[layout]``).
PAGED_LAYOUTS = ("bf16", "int8", "int4")
for _lay in PAGED_LAYOUTS:
    FORMS[f"paged_decode_attention_{_lay}"] = (
        "paged_attention", "paged_decode_attention_cuda", "paged_decode_attention", _lay)
    FORMS[f"paged_chunk_attention_{_lay}"] = (
        "paged_attention", "paged_chunk_attention_cuda", "paged_chunk_attention", _lay)


def _ops(mod: str):
    import importlib

    return importlib.import_module(f"bcg_tpu_torch.ops.{mod}")


def launch_counts():
    out = {}
    for name, (mod, _, wrapper, *lay) in FORMS.items():
        n = getattr(_ops(mod), wrapper).launches
        out[name] = n[lay[0]] if lay else n
    return out


def plain_paged_calls() -> int:
    pa = _ops("paged_attention")
    return pa.paged_decode_attention_plain.calls + pa.paged_chunk_attention_plain.calls


def zero_counts():
    for mod, _, wrapper, *lay in FORMS.values():
        fn = getattr(_ops(mod), wrapper)
        fn.launches = dict.fromkeys(PAGED_LAYOUTS, 0) if lay else 0
    pa = _ops("paged_attention")
    pa.paged_decode_attention_plain.calls = pa.paged_chunk_attention_plain.calls = 0


def keep_entry(entry):
    """A device copy of a paged cache entry: the pool blocks its table
    names (and the null block 0, first), with the table renumbered to
    the copy — the same contents and layout at a fraction of the pool."""
    import torch

    tbl = entry["tbl"]
    zero = torch.zeros(1, dtype=tbl.dtype, device=tbl.device)
    ids = torch.unique(torch.cat([zero, tbl.flatten()]))           # sorted, 0 first
    out = {k: v.index_select(0, ids.long()) for k, v in entry.items() if k != "tbl"}
    out["tbl"] = torch.searchsorted(ids, tbl).to(torch.int32).contiguous()
    return out


def keep(a):
    """A device copy of ``a`` with its strides (a KV-cache view keeps the
    full cache's batch stride, as the kernels read it in the game); a
    paged entry through :func:`keep_entry`."""
    import torch

    if isinstance(a, dict) and "tbl" in a:
        return keep_entry(a)
    if not torch.is_tensor(a):
        return a
    out = torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device=a.device)
    return out.copy_(a)


class Capture:
    """Wraps the launchers of the kernel forms ``names`` to keep a device
    copy (``keep``) of the inputs of each one's largest call: the shapes
    and data the served path gives it.  Only a call strictly larger than
    the kept one is copied (``copied_bytes`` sums the copies).  B5 keeps
    one call per weight shape (its largest), under ``("w4a16_matmul", q4
    shape)``; its largest call of all is kept under ``"w4a16_matmul"``."""

    def __init__(self, names):
        self.names = tuple(names)
        self.best = {}
        self.copied_bytes = 0
        self.orig = {}
        for name in self.names:
            mod, fn = FORMS[name][:2]
            orig = getattr(_ops(mod), fn)
            self.orig[name] = orig
            setattr(_ops(mod), fn, self._wrap(name, orig))

    def _wrap(self, name, orig):
        def wrapped(*args):
            size = sum(a.numel() for a in args if hasattr(a, "numel"))
            keys = [name]
            if name == "w4a16_matmul":
                keys.append((name, tuple(args[1].shape)))
            kept = None
            for key in keys:
                if size > self.best.get(key, (0, None))[0]:
                    if kept is None:
                        kept = tuple(keep(a) for a in args)
                        self.copied_bytes += sum(a.numel() * a.element_size()
                                                 for a in args if hasattr(a, "numel"))
                    self.best[key] = (size, kept)
            return orig(*args)
        return wrapped

    def restore(self):
        for name in self.names:
            mod, fn = FORMS[name][:2]
            setattr(_ops(mod), fn, self.orig[name])

    def inputs(self):
        return {name: args for name, (_, args) in self.best.items()}


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


def phase_small_reference():
    """tiny-dh128: kernels on the card (bf16) vs plain versions on the CPU
    (f32): prefill, 4 decode steps, a fast-forward chunk at a device-side
    write slot and a speculative chunk at per-row slots, over a dense
    bf16, int8 and int4 cache (int4: B3a and B3a-chunk on the dequantized
    view) and a paged bf16, int8 and int4 pool — every attention kernel
    form at a small size."""
    import numpy as np
    import torch

    from bcg_tpu_torch.models import transformer as tt
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params

    spec = spec_for_model("bcg-tpu/tiny-dh128")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(7)
    p32 = init_params(spec, gen, "cpu", torch.float32)
    dev = DEVICE
    p16 = {k: v.to(dev, torch.bfloat16) for k, v in p32.items()}
    rng = np.random.RandomState(0)
    B, L, S, K, K1 = 3, 150, 180, 4, 5
    tokens = torch.as_tensor(rng.randint(0, 256, (B, L)))
    valid = torch.ones((B, L), dtype=torch.bool)
    valid[0, :37] = False
    valid[2, :90] = False
    steps = torch.as_tensor(rng.randint(0, 256, (B, 4)))
    chunk = torch.as_tensor(rng.randint(0, 256, (B, K)))
    cvalid = torch.tensor([[1, 1, 1, 0], [1, 1, 1, 1], [1, 0, 0, 0]], dtype=torch.bool)
    spec_chunk = torch.as_tensor(rng.randint(0, 256, (B, K1)))
    svalid = torch.tensor([[1, 1, 0, 0, 0], [1, 1, 1, 1, 1], [1, 1, 1, 0, 0]], dtype=torch.bool)
    rwp = torch.tensor([L + 8, L + 9, L + 10])

    def run(params, dev, quantized):
        cache = tt.init_kv_cache(spec, B, S, torch.bfloat16, dev, quantized=quantized)
        logits, cache = tt.prefill(params, spec, tokens.to(dev), valid.to(dev), cache)
        outs = [logits.float().cpu()]
        vm = torch.zeros((B, S), dtype=torch.bool, device=dev)
        vm[:, :L] = valid.to(dev)
        lens = valid.sum(1).to(torch.int32).to(dev)
        for i in range(4):
            vm[:, L + i] = True
            logits, cache = tt.decode_step(params, spec, steps[:, i].to(dev), L + i,
                                           lens + i, cache, vm)
            outs.append(logits.float().cpu())
        pos = (lens + 4)[:, None] + torch.arange(K, device=dev)
        logits, cache = tt.decode_chunk(params, spec, chunk.to(dev), cvalid.to(dev),
                                        torch.tensor(L + 4, device=dev), pos, cache, vm)
        outs.append(logits.float().cpu())
        vm[:, L + 4:L + 8] = cvalid.to(dev)
        pos = (lens + 8)[:, None] + torch.arange(K1, device=dev)
        logits, cache = tt.decode_chunk_spec(params, spec, spec_chunk.to(dev), svalid.to(dev),
                                             rwp.to(dev), pos, cache, vm)
        outs += list(logits.float().cpu().unbind(1))
        return torch.stack(outs)

    # The paged pools: a right-padded prefill through a shuffled table
    # (null padding in the last column), then the same steps and chunks.
    from bcg_tpu_torch.ops.paged_attention import init_block_pool

    bs = 16
    nblk = -(-S // bs) + 1
    tbl = torch.as_tensor(rng.permutation(np.arange(1, B * nblk + 1))
                          .reshape(B, nblk).astype(np.int32))
    tbl[:, -1] = 0
    rvalid = torch.zeros((B, L), dtype=torch.bool)
    for b in range(B):
        rvalid[b, : int(valid[b].sum())] = True

    def run_paged(params, dev, quantized):
        pool = init_block_pool(spec, B * nblk + 1, bs, quantized=quantized, device=dev)
        cache = [{**e, "tbl": tbl.to(dev)} for e in pool]
        Sp = nblk * bs
        logits, cache = tt.prefill_paged(
            params, spec, tokens.to(dev), rvalid.to(dev), cache,
            torch.zeros((B, 0), dtype=torch.bool, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev))
        outs = [logits.float().cpu()]
        vm = torch.zeros((B, Sp), dtype=torch.bool, device=dev)
        vm[:, :L] = rvalid.to(dev)
        lens = rvalid.sum(1).to(torch.int32).to(dev)
        for i in range(4):
            vm[:, L + i] = True
            logits, cache = tt.decode_step(params, spec, steps[:, i].to(dev), L + i,
                                           lens + i, cache, vm)
            outs.append(logits.float().cpu())
        pos = (lens + 4)[:, None] + torch.arange(K, device=dev)
        logits, cache = tt.decode_chunk(params, spec, chunk.to(dev), cvalid.to(dev),
                                        torch.tensor(L + 4, device=dev), pos, cache, vm)
        outs.append(logits.float().cpu())
        vm[:, L + 4:L + 8] = cvalid.to(dev)
        pos = (lens + 8)[:, None] + torch.arange(K1, device=dev)
        logits, cache = tt.decode_chunk_spec(params, spec, spec_chunk.to(dev), svalid.to(dev),
                                             rwp.to(dev), pos, cache, vm)
        outs += list(logits.float().cpu().unbind(1))
        return torch.stack(outs)

    for paged in (False, True):
        for quantized in (False, "int8", "int4"):
            fn = run_paged if paged else run
            ref = fn(p32, "cpu", quantized)
            got = fn(p16, dev, quantized)
            if not torch.isfinite(got).all():
                fail("small reference: non-finite logits from the kernels")
            err = (got - ref).abs().max().item()
            what = "CPU f32"
            if quantized == "int4":
                # int4's step is absmax / 7: a key that bf16 and f32 weights
                # compute one ulp apart near a rounding boundary lands a
                # whole step away (the CPU alone reads 0.38 between its bf16
                # and f32 runs here).  The int4 path is held to the CPU run
                # of the same bf16 weights through the plain versions.
                what = f"CPU bf16 (CPU f32: {err:.4g})"
                p16_cpu = {k: v.to("cpu") for k, v in p16.items()}
                err = (got - fn(p16_cpu, "cpu", quantized)).abs().max().item()
            print(f"small reference: tiny-dh128 {'paged ' if paged else ''}"
                  f"{quantized or 'bf16'} cache, prefill + 4 decode steps + ff chunk + spec "
                  f"chunk logits, card bf16 vs {what}: max_abs_err={err:.4g} "
                  f"tol={SMALL_REF_TOL}", flush=True)
            if err > SMALL_REF_TOL:
                fail(f"small reference error {err} > {SMALL_REF_TOL}")

    # Quantized weights (quantized once, on the CPU, from an f32 draw):
    # the same int8 / int4 leaves on both sides, the other leaves bf16 on
    # the card; a bf16 cache.  int4 (W4A16) is held to the f32 CPU run by
    # the largest logit error, as the other forms are.
    from bcg_tpu_torch.models.quantize import dense, quantize_params
    from bcg_tpu_torch.ops import w4_matmul

    def on(tree, d, dtype):
        return {k: ({p: t.to(d) for p, t in v.items()} if isinstance(v, dict)
                    else v.to(d, dtype)) for k, v in tree.items()}

    def counted(tree):
        launches = w4_matmul.w4a16_matmul.launches
        got = run(on(tree, dev, torch.bfloat16), dev, False)
        if not torch.isfinite(got).all():
            fail("small reference: non-finite logits with quantized weights")
        return got, w4_matmul.w4a16_matmul.launches - launches

    qtree = quantize_params(p32, spec, mode="int4")
    got, launches = counted(qtree)
    err = (got - run(qtree, "cpu", False)).abs().max().item()
    err16 = (got - run(on(qtree, "cpu", torch.bfloat16), "cpu", False)).abs().max().item()
    print(f"small reference: tiny-dh128 int4 weights, bf16 cache, prefill + 4 decode steps "
          f"+ ff chunk + spec chunk logits, card vs CPU f32 (CPU bf16: {err16:.4g}): "
          f"max_abs_err={err:.4g} tol={SMALL_REF_TOL} w4a16_launches={launches}", flush=True)
    if err > SMALL_REF_TOL:
        fail(f"small reference error with int4 weights {err} > {SMALL_REF_TOL}")
    if launches <= 0:
        fail("small reference: no B5 launch with int4 weights")

    # int8 (W8A8) quantizes each activation row to int8, so an activation
    # that two sound runs compute one bf16 ulp apart near a rounding
    # boundary lands a whole int8 step away, and the largest logit error
    # swings with such flips (see INT8_REF_REL_TOL).  It is held by the
    # relative L2 error per logit row against the CPU run with the same
    # bf16 leaves, over three weight draws, and the faulty control (layer
    # 1's w_down scale read one output channel off) must read above the
    # limit.  The int8 products themselves are held bit for bit: W8A8
    # dense on the card against the CPU at the reference's row counts.
    def rel_row(got, ref):
        return ((got - ref).pow(2).sum(-1).sqrt()
                / ref.pow(2).sum(-1).sqrt().clamp_min(1e-30)).max().item()

    for seed in INT8_REF_SEEDS:
        if seed == 7:
            p_seed = p32
        else:
            gen.manual_seed(seed)
            p_seed = init_params(spec, gen, "cpu", torch.float32)
        qtree = quantize_params(p_seed, spec, mode="int8")
        got, launches = counted(qtree)
        ref16 = run(on(qtree, "cpu", torch.bfloat16), "cpu", False)
        ref32 = run(qtree, "cpu", False)
        bad = dict(qtree)
        bad["layers.1.w_down"] = dict(qtree["layers.1.w_down"],
                                      scale=qtree["layers.1.w_down"]["scale"].roll(1))
        control = rel_row(counted(bad)[0], ref16)
        rel = rel_row(got, ref16)
        print(f"small reference: tiny-dh128 int8 weights (seed {seed}), bf16 cache, prefill + "
              f"4 decode steps + ff chunk + spec chunk logits, card vs CPU bf16: rel_row={rel:.4g} "
              f"(tol {INT8_REF_REL_TOL}) max_abs_err={(got - ref16).abs().max().item():.4g}; "
              f"vs CPU f32: rel_row={rel_row(got, ref32):.4g} "
              f"max_abs_err={(got - ref32).abs().max().item():.4g}; faulty control (w_down "
              f"scale one channel off): rel_row={control:.4g} w4a16_launches={launches}",
              flush=True)
        if rel > INT8_REF_REL_TOL:
            fail(f"small reference error with int8 weights {rel} > {INT8_REF_REL_TOL}")
        if control <= INT8_REF_REL_TOL:
            fail(f"small reference: the int8 limit {INT8_REF_REL_TOL} misses the faulty "
                 f"control ({control})")
        if launches:
            fail(f"small reference: {launches} B5 launches with int8 weights")
        if seed != INT8_REF_SEEDS[0]:
            continue
        mismatched = []
        for name in ("layers.0.wq", "layers.0.wk", "layers.0.wo", "layers.0.w_up",
                     "layers.0.w_down", "lm_head"):
            w = qtree[name]
            for rows in (B, B * K1, B * L):
                x = torch.randn((rows, w["q"].shape[0]), generator=gen).to(torch.bfloat16)
                want = dense(x, w, torch.float32)
                have = dense(x.to(dev), {k: t.to(dev) for k, t in w.items()}, torch.float32)
                if not torch.equal(have.cpu(), want):
                    mismatched.append(f"{name}@{rows}")
        print(f"small reference: W8A8 dense on the card vs the CPU, bit for bit, 6 weights x "
              f"rows {B}/{B * K1}/{B * L}: mismatched={mismatched}", flush=True)
        if mismatched:
            fail(f"small reference: W8A8 dense differs from the CPU bits at {mismatched}")


def game_config(max_rounds: int, greedy: bool = False, **engine_kw):
    from bcg_tpu_torch.config import (BCGConfig, EngineConfig, GameConfig, LLMConfig,
                                      MetricsConfig)

    llm = LLMConfig(temperature_decide=0.0, temperature_vote=0.0) if greedy else LLMConfig()
    return BCGConfig(
        game=GameConfig(num_honest=8, num_byzantine=2, max_rounds=max_rounds, seed=0),
        engine=EngineConfig(backend="torch", model_name=MODEL, **engine_kw),
        llm=llm,
        metrics=MetricsConfig(save_results=False),
    )


# The game paths: engine knobs, rounds, whether the run is timed (then
# profiled, and the kernels' inputs captured in an untimed replay of the
# game, or with ``capture_in_profile`` in the profiled round), and the
# kernel forms it runs (``capture_forms``: the ones captured, if not all;
# ``capture=False``: none).  P1 plays one round and P2 two: the script's
# time limit is shared by all nine paths.
PATHS = {
    "P1": dict(engine={}, rounds=1, timed=True,
               kernels=("flash_prefill", "decode_attention", "guided_sampler")),
    "P2": dict(engine=dict(kv_cache_dtype="int8", decode_fast_forward=True,
                           guided_compact_json=True), rounds=2, timed=True,
               kernels=("flash_prefill", "chunk_decode_attention_int8", "guided_sampler")),
    "P3": dict(engine=dict(spec_decode=True), rounds=1, timed=False,
               kernels=("flash_prefill", "chunk_decode_attention", "guided_sampler")),
    "P4": dict(engine=dict(kv_cache_dtype="int8"), rounds=1, timed=False,
               kernels=("flash_prefill", "decode_attention_int8", "guided_sampler")),
    "P5": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS), rounds=2,
               timed=True,
               kernels=("flash_prefill", "paged_decode_attention_bf16", "guided_sampler")),
    "P6": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS,
                           kv_cache_dtype="int4", decode_fast_forward=True,
                           guided_compact_json=True), rounds=1, timed=False,
               kernels=("flash_prefill", "paged_chunk_attention_int4", "guided_sampler")),
    "P7": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS,
                           kv_cache_dtype="int8", spec_decode=True), rounds=1, timed=False,
               kernels=("flash_prefill", "paged_chunk_attention_int8", "guided_sampler")),
    # The weight-quantized paths: each engine quantizes its own copy of the
    # shared bf16 weights.  P8 is the JAX bench's default 8B path (int8
    # weights, int8 KV, fast-forward, compact JSON; bench.py:1058-1093),
    # timed and profiled; P9 int4 weights over the default engine, timed,
    # profiled, B5's inputs captured.
    "P8": dict(engine=dict(quantization="int8", kv_cache_dtype="int8",
                           decode_fast_forward=True, guided_compact_json=True), rounds=1,
               timed=True, capture=False,
               kernels=("flash_prefill", "chunk_decode_attention_int8", "guided_sampler")),
    "P9": dict(engine=dict(quantization="int4"), rounds=1, timed=True,
               capture_forms=("w4a16_matmul",), capture_in_profile=True,
               kernels=("flash_prefill", "decode_attention", "guided_sampler", "w4a16_matmul")),
}
# Which path's capture feeds each kernel form's check, and whose launch
# count goes into the kernels line.  The three paged forms no game path
# reaches run on another form's captured pool (PAGED_DERIVED).
HOME = {"flash_prefill": "P1", "decode_attention": "P1", "guided_sampler": "P1",
        "chunk_decode_attention_int8": "P2", "chunk_decode_attention": "P3",
        "decode_attention_int8": "P4", "paged_decode_attention_bf16": "P5",
        "paged_chunk_attention_int4": "P6", "paged_chunk_attention_int8": "P7",
        "w4a16_matmul": "P9"}
PAGED_DERIVED = {"paged_chunk_attention_bf16": ("P5", "paged_decode_attention_bf16"),
                 "paged_decode_attention_int8": ("P7", "paged_chunk_attention_int8"),
                 "paged_decode_attention_int4": ("P6", "paged_chunk_attention_int4")}

# Kernel name fragments -> kind, for the profile's breakdown, first match
# wins (cuBLAS's matrix products show up as nvjet / gemm / gemv kernels,
# its int8 products with s8 / i8 / imma in the name).  "dequant" is the
# int4 unpack's shift kernels (the prefill route's dequantize_int4 and
# nothing else on P9); the unpack's scale product and bf16 conversion
# fall under "other".
KINDS = (
    ("flash_prefill_kernel", "flash_prefill"),
    ("decode_attention_kernel", "decode_attention"),
    ("chunk_decode_bf16_kernel", "chunk_decode_attention"),
    ("decode_int8_kernel", "decode_attention_int8"),
    ("guided_sampler_kernel", "guided_sampler"),
    ("paged_kernel", "paged_attention"),
    ("w4a16_kernel", "w4a16_matmul"), ("w4a16_reduce", "w4a16_matmul"),
    ("s8s8", "int8_gemm"), ("i8i8", "int8_gemm"), ("i8i32", "int8_gemm"), ("imma", "int8_gemm"),
    ("int8gemm", "int8_gemm"), ("_s8_", "int8_gemm"), ("igemm", "int8_gemm"),
    ("shift", "dequant"),
    ("nvjet", "matmul"), ("gemm", "matmul"), ("gemv", "matmul"), ("xmma", "matmul"),
    ("cutlass", "matmul"),
)


def play_on(engine, cfg):
    """One game under ``cfg`` on ``engine``: (wall ms, decode steps)."""
    import torch

    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    sim = BCGSimulation(cfg, engine=engine)
    steps0 = engine.total_decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, engine.total_decode_steps - steps0


def phase_profile(path, engine, capture_forms=()):
    """The path's first round again, greedy, played twice on the booted
    engine — every prompt prefix is already cached, so both runs do the
    same work: once timed, once under ``torch.profiler`` (device activity
    only).  Prints device milliseconds by kernel kind, the top kernels,
    and the device's busy share: the profiled device time over the timed
    run's wall time (the profiler's own overhead slows the profiled run).
    ``capture_forms``: kernel forms whose inputs are captured in the
    profiled run only (whose wall time the share does not use); returns
    that :class:`Capture`, or None."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = game_config(1, greedy=True, **PATHS[path]["engine"])

    def play():
        return play_on(engine, cfg)

    wall_ms, steps = play()
    t_prof = time.perf_counter()
    capture = Capture(capture_forms) if capture_forms else None
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        try:
            profiled_ms, profiled_steps = play()
        finally:
            if capture is not None:
                capture.restore()
    t0 = time.perf_counter()
    stop_s = t0 - t_prof - profiled_ms / 1e3
    # Device activity by name, from the profiler's raw events: the same
    # sums as key_averages()' device times, without building its Python
    # event tree (which takes tens of seconds for a round's ~250K launches).
    by_name = {}
    for evt in prof.profiler.kineto_results.events():
        if evt.device_type() == DeviceType.CUDA:
            ms, n = by_name.get(evt.name(), (0.0, 0))
            by_name[evt.name()] = (ms + evt.duration_ns() / 1e6, n + 1)
    rows = sorted(((ms, n, key) for key, (ms, n) in by_name.items() if ms > 0), reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    kinds = {}
    for ms, _, key in rows:
        kind = next((k for frag, k in KINDS if frag in key.lower()), "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"profile {path}: " + json.dumps({
        "round_wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
        "decode_steps": [steps, profiled_steps], "device_busy_ms": busy,
        "device_busy_share": busy / wall_ms if rows else None,
        "by_kind_ms": kinds,
        "top": [{"kernel": key[:90], "ms": ms, "count": n} for ms, n, key in rows[:8]],
        "profiler_stop_seconds": stop_s, "summary_seconds": time.perf_counter() - t0,
        **({"capture_copied_bytes": capture.copied_bytes} if capture is not None else {}),
    }), flush=True)
    return capture


DENSE_KV_BYTES = {}


def phase_path(path, params):
    """Play one game path on a fresh engine over the shared weights.
    Returns its launch counts and the captured inputs of its kernels."""
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    conf = PATHS[path]
    cfg = game_config(conf["rounds"], **conf["engine"])
    t0 = time.perf_counter()
    engine = TorchEngine(cfg.engine, device=DEVICE, params=params)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    capture = conf.get("capture", True)
    forms = conf.get("capture_forms", conf["kernels"])
    cap = Capture(forms) if capture and not conf["timed"] else None
    try:
        zero_counts()
        t0 = time.perf_counter()
        sim = BCGSimulation(cfg, engine=engine)
        stats = sim.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        plain_calls = plain_paged_calls()
    finally:
        if cap is not None:
            cap.restore()
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
        "kv_cache_bytes": engine.max_kv_cache_bytes,
        "launches": {k: counts[k] for k in conf["kernels"]},
        "plain_paged_calls": plain_calls,
    }
    if path != "P1":
        line.update(
            timed=conf["timed"],
            decode_steps_per_decision=engine.total_decode_steps / max(decisions, 1),
            plain_loop_steps=engine.total_plain_steps,
            steps_vs_plain_loop=engine.total_decode_steps / max(engine.total_plain_steps, 1),
            kv_slot_bytes_per_layer=engine._kv_slot_bytes,
        )
    if path == "P1":
        DENSE_KV_BYTES["P1"] = engine.max_kv_cache_bytes
    pool = engine.kv_pool_stats()
    if pool is not None:
        # kv_cache_bytes is the largest batch's PRIVATE blocks (the radix-
        # shared prefix is counted once, in blocks_resident).
        line.update(
            kv_dtype=pool["kv_dtype"], blocks_total=pool["blocks_total"],
            blocks_resident=pool["blocks_resident"], blocks_free=pool["blocks_free"],
            prefix_hit_rate=pool["prefix_hit_rate"], block_size=pool["block_size"],
            prefix_hit_positions=engine._paged._hit_positions,
            prefix_lookup_positions=engine._paged._lookup_positions,
            block_bytes_all_layers=engine._paged.block_bytes_dev,
            auto_pool_blocks=engine._auto_pool_blocks(pool["block_size"]),
            p1_dense_kv_cache_bytes=DENSE_KV_BYTES.get("P1"),
            impl=pool["impl"],
        )
    if engine.spec_decode:
        line.update(spec_drafted=engine.spec_drafted, spec_accepted=engine.spec_accepted)
    if engine.quantization:
        line.update(quantization=engine.quantization, param_bytes=engine._param_bytes)
    print(f"game {path}: " + json.dumps(line), flush=True)
    if stats["total_rounds"] < 1 or len(stats) < 40:
        fail(f"{path}: game statistics malformed: {sorted(stats)[:5]}...")
    for name in conf["kernels"]:
        if counts[name] <= 0:
            fail(f"{path}: kernel {name} was never launched on the game path")
    if engine.failed_rows:
        fail(f"{path}: {engine.failed_rows} rows failed to produce schema-valid JSON")
    if plain_calls:
        fail(f"{path}: the plain paged attention ran {plain_calls} times on the card")
    if conf["timed"]:
        in_profile = capture and conf.get("capture_in_profile", False)
        cap = phase_profile(path, engine, forms if in_profile else ())
        if capture and not in_profile:
            # The kernels' inputs at the sampled game's shapes: the game
            # again, untimed, with the launchers wrapped.
            cap = Capture(forms)
            try:
                BCGSimulation(cfg, engine=engine).run()
            finally:
                cap.restore()
    torch.cuda.synchronize()
    engine.shutdown()
    del engine, sim
    torch.cuda.empty_cache()
    return counts, cap.inputs() if cap is not None else {}


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


def w4_line(x, q4, gscale):
    """B5 against its plain version at one input: relative L2 error per
    output row, the kernel's, the plain version's and the bound's
    times, and beside them ``torch.matmul`` of x with the weight
    ALREADY dequantized to bf16 (another function: the bf16 product
    int4 has to beat, not a library call of B5's)."""
    import torch

    from bcg_tpu_torch.models.quantize import dequantize_int4
    from bcg_tpu_torch.ops import w4_matmul as w4

    out = w4.w4a16_matmul_cuda(x, q4, gscale)
    torch.cuda.synchronize()
    ref = w4.w4a16_matmul_plain(x, q4, gscale)
    rel = ((out - ref).pow(2).sum(-1).sqrt()
           / ref.pow(2).sum(-1).sqrt().clamp_min(1e-30)).max().item()
    err = (out - ref).abs().max().item()
    ok = rel <= W4_REL_ROW_TOL and bool(torch.isfinite(out).all())
    del out, ref
    # Enough weight copies that a graph of calls reads more than twice the
    # L2 (the LM head alone is 311 MB).
    copies = max(1, min(64, -(-100_000_000 // q4.numel())))
    reps = max(20, copies)
    ws = [(q4, gscale)] + [(q4.clone(), gscale.clone()) for _ in range(copies - 1)]
    ms = graph_ms([lambda q=q, g=g: w4.w4a16_matmul_cuda(x, q, g) for q, g in ws], reps)
    plain_ms = time_ms(lambda: w4.w4a16_matmul_plain(x, q4, gscale), reps=5)
    xb = x.to(torch.bfloat16)
    w_bfs = [dequantize_int4({"q4": q, "gscale": g}) for q, g in ws]
    deq_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in w_bfs], reps)
    del ws, w_bfs
    (M, D), F = x.shape, q4.shape[1]
    # q4, gscale and x read once, the f32 output written once.
    byts = q4.numel() + 2 * gscale.numel() + 2 * x.numel() + 4 * M * F
    bms, by = bound(byts, 2 * M * D * F)
    return dict(max_abs_err=err, rel_row=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, dequantized_bf16_matmul_ms=deq_ms,
                shape=[M, D, F], group=q4.shape[0] // (gscale.shape[0] // 2))


def w4a16_check(captured):
    """B5 at P9's largest call (the LM head at M = 10), then at one
    captured weight of each layer shape with M = 1, 10, 50 and 256 rows
    (the captured rows repeated).  ``captured``: P9's captured inputs."""
    import torch

    x, q4, gscale = captured["w4a16_matmul"]
    head = w4_line(x, q4, gscale)
    extra = []
    shapes = sorted(k[1] for k in captured if isinstance(k, tuple))
    for shape in shapes:
        xc, q, g = captured[("w4a16_matmul", shape)]
        for M in (1, 10, 50, 256):
            xm = xc[torch.arange(M, device=xc.device) % xc.shape[0]].contiguous()
            extra.append(w4_line(xm, q, g))
        torch.cuda.empty_cache()
    return dict(replaces="bcg_tpu/ops/w4_matmul.py:37 _w4_kernel (pallas_call :116 of "
                         "_w4a16_2d :107, via w4a16_matmul :150)",
                **head, library_ms=None, shapes=extra)


def phase_kernels(inputs, counts):
    """Each kernel form against its plain version on its home path's
    captured inputs.  ``inputs``/``counts``: per path."""
    import torch
    import torch.nn.functional as F

    from bcg_tpu_torch.ops import attention, decode_attention as da, guided_sampler

    results = []
    errors = []

    def common(name):
        src = "decode_attention_int8" if name == "chunk_decode_attention_int8" else name
        if name.startswith("paged_"):
            src = "paged_attention"
        if name == "w4a16_matmul":
            src = "w4a16"
        per_path = {p: c[name] for p, c in counts.items()}
        # A form on no game path reports its launches summed over the paths.
        return dict(name=name, route="cuda", source=f"bcg_tpu_torch/csrc/{src}.cu",
                    launches=per_path[HOME[name]] if name in HOME else sum(per_path.values()),
                    launches_per_path=per_path)

    def flash():
        q, k, v, mask, scale = inputs["P1"]["flash_prefill"]
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
        return dict(common("flash_prefill"),
                    replaces="bcg_tpu/ops/attention.py:37 _flash_kernel",
                    **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, shape=[B, T, H, Hkv, S], live_pairs=live)

    def decode():
        q, k, v, mask, scale = inputs["P1"]["decode_attention"]
        out = da.decode_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, mask, scale)
        dropped = da.decode_attention_plain(q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (-1,), dropped)
        ms = time_ms(lambda: da.decode_attention_cuda(q, k, v, mask, scale), reps=50)
        plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, mask, scale))
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
        return dict(common("decode_attention"),
                    replaces="bcg_tpu/ops/decode_attention.py:57 _decode_kernel",
                    **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, shape=[B, H, Hkv, S], valid_slots=valid)

    def chunk():
        q, k, v, mask, scale = inputs["P3"]["chunk_decode_attention"]
        out = da.chunk_decode_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = da.chunk_decode_attention_plain(q, k, v, mask, scale)
        dropped = da.chunk_decode_attention_plain(q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        ms = time_ms(lambda: da.chunk_decode_attention_cuda(q, k, v, mask, scale), reps=50)
        plain_ms = time_ms(lambda: da.chunk_decode_attention_plain(q, k, v, mask, scale))
        B, K, H, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        group = H // Hkv
        kt = k.transpose(1, 2).repeat_interleave(group, 1)
        vt = v.transpose(1, 2).repeat_interleave(group, 1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kt, vt, attn_mask=mask[:, None], scale=scale), reps=50)
        # Slots any chunk row of a batch row attends, read once; q, out
        # (bf16) and the [B, K, S] mask once.
        slots = mask.any(1).sum().item()
        byts = 2 * (2 * slots * Hkv * Dh) + 2 * 2 * q.numel() + mask.numel()
        bms, by = bound(byts, 4 * Dh * H * mask.sum().item())
        return dict(common("chunk_decode_attention"),
                    replaces="bcg_tpu/ops/decode_attention.py:381 _decode_kernel (chunk "
                             "pallas_call of chunk_decode_attention :308)",
                    **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, shape=[B, K, H, Hkv, S], valid_slots=slots)

    def int8_forms(name, path):
        q, k, v, ks, vs, mask, scale = inputs[path][name]
        launch = getattr(da, f"{name}_cuda")
        plain = getattr(da, f"{name}_plain")
        out = launch(q, k, v, ks, vs, mask, scale)
        torch.cuda.synchronize()
        ref = plain(q, k, v, ks, vs, mask, scale)
        dropped = plain(q, k, v, ks, vs, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3) if q.dim() == 4 else (-1,), dropped)
        ms = time_ms(lambda: launch(q, k, v, ks, vs, mask, scale), reps=50)
        plain_ms = time_ms(lambda: plain(q, k, v, ks, vs, mask, scale))
        Hkv, S, Dh = k.shape[1], k.shape[2], k.shape[3]
        H = q.shape[-2]
        m3 = mask if mask.dim() == 3 else mask[:, None]
        slots = m3.any(1).sum().item()
        # int8 k and v plus their two f32 scales per attended slot and kv
        # head, as stored; q, out (bf16) and the mask once.
        byts = slots * Hkv * (2 * Dh + 8) + 2 * 2 * q.numel() + m3.numel()
        bms, by = bound(byts, 4 * Dh * H * m3.sum().item())
        return dict(common(name),
                    replaces=("bcg_tpu/ops/decode_attention.py:113 _decode_kernel_allheads "
                              "(pallas_call :182 of _quantized_attention :166, via "
                              + ("chunk_decode_attention :327-359)" if q.dim() == 4
                                 else "decode_attention :241-264)")),
                    **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None, shape=list(q.shape[:-1]) + [Hkv, S], valid_slots=slots)

    def flash_p5():
        """B1 at P5's captured prefill input: the paged prefill's tokens
        are right-padded, so each row's pad query rows come last."""
        q, k, v, mask, scale = inputs["P5"]["flash_prefill"]
        out = attention.flash_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = per_row(attention.flash_attention_plain, q, k, v, mask, scale)
        dropped = per_row(attention.flash_attention_plain, q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        tail_pad = bool((~mask.any(2))[:, -1].any())
        return dict(name="flash_prefill@P5", **check, shape=list(q.shape[:3]) + [k.shape[1]],
                    right_padded_rows=tail_pad)

    def paged_inputs(name):
        """Captured inputs of a paged form, or, for the forms no game path
        reaches, inputs made from another form's captured pool and table."""
        if name in HOME:
            return inputs[HOME[name]][name]
        path, src = PAGED_DERIVED[name]
        q, entry, mask, scale = inputs[path][src]
        if name.startswith("paged_decode"):          # the chunk's first position
            return q[:, :1].contiguous(), entry, mask[:, 0].contiguous(), scale
        # A K = 5 query over the step's pool: row k attends the step's
        # live keys minus the last 4 - k of them (a causal chunk's mask).
        K = 5
        gen = torch.Generator(device=q.device)
        gen.manual_seed(5)
        qk = (torch.randn((q.shape[0], K) + tuple(q.shape[2:]), generator=gen,
                          device=q.device) * q.float().std()).to(q.dtype)
        m = mask[:, None, :].repeat(1, K, 1)
        for b in range(mask.shape[0]):
            live = mask[b].nonzero().flatten()
            for kk in range(K - 1):
                m[b, kk, live[len(live) - (K - 1 - kk):]] = False
        return qk, entry, m, scale

    def paged(name):
        from bcg_tpu_torch.ops import paged_attention as pa

        lay = FORMS[name][3]
        step = name.startswith("paged_decode")
        q, entry, mask, scale = paged_inputs(name)
        launch = pa.paged_decode_attention_cuda if step else pa.paged_chunk_attention_cuda
        plain = pa.paged_decode_attention_plain if step else pa.paged_chunk_attention_plain
        out = launch(q, entry, mask, scale)
        torch.cuda.synchronize()
        ref = plain(q, entry, mask, scale)
        dropped = plain(q, entry, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        ms = time_ms(lambda: launch(q, entry, mask, scale), reps=50)
        plain_ms = time_ms(lambda: plain(q, entry, mask, scale))
        # The dense kernel over the gathered dense view of the same inputs
        # (int4: dequantized to bf16, as the dense int4 path serves it).
        dense = pa.paged_gather_entry(entry)
        m3 = mask[:, None] if step else mask
        if lay == "int8":
            dk = (dense["k"], dense["v"], dense["k_scale"], dense["v_scale"])
            dfn = (lambda: da.decode_attention_int8_cuda(q[:, 0], *dk, mask, scale)[:, None]) \
                if step else (lambda: da.chunk_decode_attention_int8_cuda(q, *dk, mask, scale))
        else:
            kd, vd = pa._dense_view(entry, q.dtype)
            dfn = (lambda: da.decode_attention_cuda(q[:, 0], kd, vd, mask, scale)[:, None]) \
                if step else (lambda: da.chunk_decode_attention_cuda(q, kd, vd, mask, scale))
        dense_rel_row, dense_rel_head = rel_errors(dfn(), out, (1, 3))
        dense_ms = time_ms(dfn, reps=50)
        del dense
        B, Kq, H, Dh = q.shape
        tbl, bs = entry["tbl"], pa.block_size(entry)
        Hkv = pa.num_kv_heads(entry)
        nblk = tbl.shape[1]
        live_cols = m3.reshape(B, -1, nblk, bs).any(3).any(1)          # [B, nblk]
        blocks = torch.unique(tbl[live_cols]).numel()
        per_pos = {"bf16": 2 * Dh * 2, "int8": 2 * (Dh + 4), "int4": 2 * (Dh // 2 + 2)}[lay]
        # The live blocks' K and V (and scales) read once; q, out (bf16),
        # the mask and the table once.
        byts = blocks * bs * Hkv * per_pos + 2 * 2 * q.numel() + m3.numel() + 4 * tbl.numel()
        bms, by = bound(byts, 4 * Dh * H * m3.sum().item())
        src = PAGED_DERIVED.get(name)
        return dict(common(name),
                    replaces=("bcg_tpu/ops/paged_attention.py:341 _paged_kernel (pallas_call "
                              ":507 of _paged_pallas_attention :432, via "
                              + ("paged_decode_attention :221)" if step
                                 else "paged_chunk_attention :262)")),
                    **check, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None, dense_ms=dense_ms, dense_rel_row=dense_rel_row,
                    dense_rel_head=dense_rel_head, live_blocks=blocks,
                    inputs_from=(f"{src[0]} {src[1]}" if src else HOME[name]),
                    shape=[B, Kq, H, Hkv, nblk * bs, bs])

    def sampler():
        logits, minb, dfa_ids, states, meta_i, meta_f, eos_id, _top_p = \
            inputs["P1"]["guided_sampler"]
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
        return dict(common("guided_sampler"),
                    replaces="bcg_tpu/ops/guided_sampler.py:93 _sampler_kernel",
                    max_abs_err=float(err), token_mismatches=mismatches, ok=mismatches == 0,
                    ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                    shape=[B, V])

    def w4a16():
        return dict(common("w4a16_matmul"), **w4a16_check(inputs["P9"]))

    for phase in (flash, decode, sampler, chunk,
                  lambda: int8_forms("decode_attention_int8", "P4"),
                  lambda: int8_forms("chunk_decode_attention_int8", "P2"),
                  *[lambda n=f"paged_{form}_attention_{lay}": paged(n)
                    for form in ("decode", "chunk") for lay in PAGED_LAYOUTS], w4a16):
        results.append(phase())
        torch.cuda.empty_cache()
    extra = flash_p5()
    print(f"kernel {extra['name']}: rel_row={extra['rel_row']:.4g} (tol {ATTN_REL_ROW_TOL}) "
          f"rel_head={extra['rel_head']:.4g} (tol {ATTN_REL_HEAD_TOL}) with {DROP_KEYS} live "
          f"keys dropped: rel_row={extra['dropped_rel_row']:.4g} "
          f"rel_head={extra['dropped_rel_head']:.4g} right_padded_rows="
          f"{extra['right_padded_rows']} shape={extra['shape']}", flush=True)
    if not extra["ok"]:
        errors.append("flash_prefill at P5's right-padded input disagrees with its plain version")
    for r in results:
        if r["name"] == "w4a16_matmul":
            for e in [r] + r["shapes"]:
                print(f"kernel w4a16_matmul: shape[M,D,F]={e['shape']} group={e['group']} "
                      f"rel_row={e['rel_row']:.4g} (tol {W4_REL_ROW_TOL}) "
                      f"max_abs_err={e['max_abs_err']:.4g} ms={e['ms']:.4f} "
                      f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
                      f"({e['bound_by']}) dequantized_bf16_matmul_ms="
                      f"{e['dequantized_bf16_matmul_ms']:.4f} launches={r['launches']} "
                      f"per_path={json.dumps(r['launches_per_path'])}", flush=True)
                if not e["ok"]:
                    errors.append(f"w4a16_matmul at {e['shape']}: disagrees with its plain "
                                  "version")
            continue
        if "rel_row" in r:
            err = (f"max_abs_err={r['max_abs_err']:.4g} ref_rms={r['ref_rms']:.4g} "
                   f"ref_max={r['ref_max']:.4g} rel_row={r['rel_row']:.4g} "
                   f"(tol {ATTN_REL_ROW_TOL}) rel_head={r['rel_head']:.4g} "
                   f"(tol {ATTN_REL_HEAD_TOL}) with {DROP_KEYS} live keys dropped: "
                   f"rel_row={r['dropped_rel_row']:.4g} rel_head={r['dropped_rel_head']:.4g}")
        else:
            err = f"token_mismatches={r['token_mismatches']} (tol 0)"
        if "dense_ms" in r:
            err += (f" dense_ms={r['dense_ms']:.4f} dense_rel_row={r['dense_rel_row']:.4g} "
                    f"live_blocks={r['live_blocks']} inputs_from={r['inputs_from']}")
        print(f"kernel {r['name']}: {err} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) launches={r['launches']} "
              f"per_path={json.dumps(r['launches_per_path'])} shape={r['shape']}", flush=True)
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
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.convert import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()
    phase_build()
    t0 = time.perf_counter()
    phase_small_reference()
    print(f"phase small reference: {time.perf_counter() - t0:.1f} s", flush=True)
    # One set of bench-8b weights for every path: the default engine's own
    # draw (seed 0 on the card).
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    params = init_params(spec_for_model(MODEL), gen, DEVICE)
    torch.cuda.synchronize()
    print(f"weights: {MODEL} initialised on the card in {time.perf_counter() - t0:.1f} s",
          flush=True)
    counts, inputs = {}, {}
    for path in PATHS:
        t0 = time.perf_counter()
        counts[path], inputs[path] = phase_path(path, params)
        print(f"phase {path}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    results, errors = phase_kernels(inputs, counts)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card line", flush=True)
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
