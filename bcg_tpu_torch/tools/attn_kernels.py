"""B1 (flash prefill) and B3a (bf16 decode step) against their plain
versions and ``scaled_dot_product_attention``, at bench-8b's game shapes
with synthetic inputs, in one process.

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.attn_kernels [--seed 0] [--reps 20]

Inputs (made on the card from the seed): 32 query heads over 8 kv heads
of 128 dims; B1 at 10 rows of a 4096-position left-padded causal suffix
over a 768-position left-padded cached prefix (S 4864, the shape of the
sampled game's largest prefill); B3a at 10 rows over a 5065-slot window
with a left pad per row.  K/V are strided views of one [B, S, 2, Hkv,
Dh] buffer, as the cache holds them.  For each kernel: the relative L2
error per query row and head and per batch row and head against the
plain version (limits 0.02 / 0.01, as ``chip_smoke.py``), the kernel's
time event-timed per call and in a CUDA graph of calls, the same two for
SDPA over the GQA-expanded k/v (the yardstick, never used by the port),
their ratio, and the bound.  Much quicker than ``chip_smoke.py`` (no
game), for work on these two kernels; ``chip_smoke.py`` holds them at
the game's own captured inputs.  Prints the card's name and power limit
and one JSON line per kernel; exits 1 if a kernel disagrees.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
REL_ROW_TOL, REL_HEAD_TOL = 2e-2, 1e-2


def _event_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _graph_ms(fn, reps):
    """Device time of one call: ``reps`` calls captured in a CUDA graph,
    the graph replayed five times, the median per call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return statistics.median(times)


def _rel(out, ref, head_dims):
    diff, ref2 = (out.float() - ref.float()).pow(2), ref.float().pow(2)

    def worst(dims):
        return (diff.sum(dims).sqrt() / ref2.sum(dims).sqrt().clamp_min(1e-30)).max().item()

    return worst((-1,)), worst(head_dims)


def _bound(byts, flops):
    tb, tf = byts / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def prefill_inputs(gen, B=10, T=4096, P=768, H=32, Hkv=8, Dh=128):
    import torch

    dev = "cuda"
    S = P + T
    q = torch.randn((B, T, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, S, 2, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pre_pad = torch.randint(0, P // 2, (B,), generator=gen, device=dev)
    suf_pad = torch.randint(0, T // 2, (B,), generator=gen, device=dev)
    t = torch.arange(T, device=dev)
    s = torch.arange(S, device=dev)
    q_live = t[None] >= suf_pad[:, None]                                      # [B, T]
    pre = (s[None, None] < P) & (s[None, None] >= pre_pad[:, None, None])     # [B, 1, S]
    suf = (s[None, None] >= P) & (s[None, None] - P <= t[None, :, None]) \
        & (s[None, None] - P >= suf_pad[:, None, None])                       # [B, T, S]
    mask = (pre | suf) & q_live[:, :, None]
    return q, kv[:, :, 0], kv[:, :, 1], mask.contiguous(), Dh ** -0.5


def decode_inputs(gen, B=10, S=5065, H=32, Hkv=8, Dh=128):
    import torch

    dev = "cuda"
    q = torch.randn((B, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    kv = torch.randn((B, S, 2, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pad = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    mask = torch.arange(S, device=dev)[None] >= pad[:, None]
    return q, kv[:, :, 0], kv[:, :, 1], mask, Dh ** -0.5


def run_prefill(gen, reps):
    import torch
    import torch.nn.functional as F

    from bcg_tpu_torch.ops import attention

    q, k, v, mask, scale = prefill_inputs(gen)
    out = attention.flash_attention_cuda(q, k, v, mask, scale)
    torch.cuda.synchronize()
    ref = torch.cat([attention.flash_attention_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                                     mask[b:b + 1], scale)
                     for b in range(q.shape[0])])
    rel_row, rel_head = _rel(out, ref, (1, 3))
    del out, ref
    B, T, H, Dh = q.shape
    Hkv = k.shape[2]
    call = lambda: attention.flash_attention_cuda(q, k, v, mask, scale)   # noqa: E731
    ms, gms = _event_ms(call, reps), _graph_ms(call, max(2, reps // 4))
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vt = v.transpose(1, 2).repeat_interleave(H // Hkv, 1)
    lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],  # noqa: E731
                                                 scale=scale)
    lib_ms, lib_gms = _event_ms(lib, max(3, reps // 4)), _graph_ms(lib, 2)
    live = mask.sum().item()
    bms, by = _bound(2 * (2 * q.numel() + k.numel() + v.numel()) + mask.numel(),
                     4 * Dh * H * live)
    return dict(name="flash_prefill", shape=[B, T, H, Hkv, k.shape[1]], live_pairs=live,
                rel_row=rel_row, rel_head=rel_head, ms=ms, graph_ms=gms, library_ms=lib_ms,
                library_graph_ms=lib_gms, library_ratio=ms / lib_ms, bound_ms=bms, bound_by=by)


def run_decode(gen, reps):
    import torch
    import torch.nn.functional as F

    from bcg_tpu_torch.ops import decode_attention as da

    q, k, v, mask, scale = decode_inputs(gen)
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_split, split_len = da._split_for(q, Hkv, S, 1)
    out = da.decode_attention_cuda(q, k, v, mask, scale)
    torch.cuda.synchronize()
    rel_row, rel_head = _rel(out, da.decode_attention_plain(q, k, v, mask, scale), (-1,))
    split_row, split_head = _rel(
        out, da.decode_attention_split_plain(q, k, v, mask, scale, n_split, split_len), (-1,))
    call = lambda: da.decode_attention_cuda(q, k, v, mask, scale)   # noqa: E731
    ms, gms = _event_ms(call, reps), _graph_ms(call, reps)
    kt = k.transpose(1, 2).repeat_interleave(H // Hkv, 1)
    vt = v.transpose(1, 2).repeat_interleave(H // Hkv, 1)
    lib = lambda: F.scaled_dot_product_attention(q[:, :, None], kt, vt,  # noqa: E731
                                                 attn_mask=mask[:, None, None], scale=scale)
    lib_ms, lib_gms = _event_ms(lib, reps), _graph_ms(lib, reps)
    valid = mask.sum().item()
    bms, by = _bound(2 * (2 * valid * Hkv * Dh) + 2 * 2 * q.numel() + mask.numel(),
                     4 * Dh * H * valid)
    return dict(name="decode_attention", shape=[B, H, Hkv, S], split=[n_split, split_len],
                rel_row=rel_row, rel_head=rel_head, split_rel_row=split_row,
                split_rel_head=split_head, ms=ms, graph_ms=gms, library_ms=lib_ms,
                library_graph_ms=lib_gms, library_ratio=gms / lib_gms, bound_ms=bms,
                bound_by=by)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attn_kernels: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    ok = True
    for run in (run_decode, run_prefill):
        r = run(gen, args.reps)
        ok &= r["rel_row"] <= REL_ROW_TOL and r["rel_head"] <= REL_HEAD_TOL
        if "split_rel_row" in r:
            ok &= r["split_rel_row"] <= REL_ROW_TOL and r["split_rel_head"] <= REL_HEAD_TOL
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
