"""The attention kernels against their plain versions at bench-8b's game
shapes with synthetic inputs, in one process: B1 (flash prefill) and B3a
(bf16 decode step) also against ``scaled_dot_product_attention``, and the
split forms of B3a-chunk (bf16 chunk), B3b (int8 decode: single step and
chunk) and B4 (paged decode over bf16, int8 and int4 pools: single step
and chunk).

Run from the repository root on a machine with one CUDA card:

    python -m bcg_tpu_torch.tools.attn_kernels [--seed 0] [--reps 20]

Inputs (made on the card from the seed): 32 query heads over 8 kv heads
of 128 dims; B1 at 10 rows of a 4096-position left-padded causal suffix
over a 768-position left-padded cached prefix (S 4864, the shape of the
sampled game's largest prefill); B3a at 10 rows over a 5065-slot window
with a left pad per row; B3a-chunk, B3b and B4 at 10 rows over a
5072-slot window with a left pad per row (B4: a pool of shuffled blocks
of 16, one table row each), the chunks at their paths' K (B3a-chunk 5;
B3b 4; B4 bf16 5, int8 5, int4 4, each chunk position one more slot than
the one before).  K/V of the
bf16 cache are strided views of one [B, S, 2, Hkv, Dh] buffer, as the
cache holds them.  For each kernel: the relative L2 error per query row
and head and per batch row and head against the plain version (limits
0.02 / 0.01, as ``chip_smoke.py``) and, for the split kernels, against
the plain version of the split arithmetic at the kernel's plan
(``split``: the split count and positions per split); the kernel's time
event-timed per call and in a CUDA graph of calls; for B1 and B3a the
same two for SDPA over the GQA-expanded k/v (the yardstick, never used
by the port) and their ratio; and the bound.  Much quicker than
``chip_smoke.py`` (no game), for work on these kernels; ``chip_smoke.py``
holds them at the game's own captured inputs.  Prints the card's name
and power limit and one JSON line per kernel; exits 1 if a kernel
disagrees.
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


# B3a-chunk's, B3b's and B4's split forms: (name, cache, K), K = 0 for
# the single step.
SPLIT_FORMS = [("chunk_decode_attention", "dense-bf16", 5),
               ("decode_attention_int8", "dense-int8", 0),
               ("chunk_decode_attention_int8", "dense-int8", 4),
               ("paged_decode_attention_bf16", "bf16", 0),
               ("paged_chunk_attention_bf16", "bf16", 5),
               ("paged_decode_attention_int8", "int8", 0),
               ("paged_chunk_attention_int8", "int8", 5),
               ("paged_decode_attention_int4", "int4", 0),
               ("paged_chunk_attention_int4", "int4", 4)]


def split_inputs(gen, cache, K, B=10, S=5072, H=32, Hkv=8, Dh=128, bs=16):
    """q [B, max(K, 1), H, Dh], the cache (bf16 k/v as strided views of
    one [B, S, 2, Hkv, Dh] buffer, int8 k/v/scales, or a paged entry over
    a pool of B * S / bs shuffled blocks and block 0) and the
    mask [B, max(K, 1), S]: a left pad per row, chunk position k
    attending one more slot than k - 1."""
    import torch
    from types import SimpleNamespace

    from bcg_tpu_torch.models.quantize import quantize_kv_int4
    from bcg_tpu_torch.ops import decode_attention as da, paged_attention as pa

    dev = "cuda"
    Kq = max(K, 1)
    q = torch.randn((B, Kq, H, Dh), generator=gen, device=dev).to(torch.bfloat16)
    pad = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    s = torch.arange(S, device=dev)
    end = S - Kq + 1 + torch.arange(Kq, device=dev)                   # [Kq]
    mask = (s[None, None] >= pad[:, None, None]) & (s[None, None] < end[None, :, None])
    if cache == "dense-bf16":
        kv = torch.randn((B, S, 2, Hkv, Dh), generator=gen, device=dev).to(torch.bfloat16)
        return q, (kv[:, :, 0], kv[:, :, 1]), mask
    if cache == "dense-int8":
        x = torch.randn((2, B, Hkv, S, Dh), generator=gen, device=dev)
        vals, sc = da.quantize_kv(x)
        return q, (vals[0], vals[1], sc[0], sc[1]), mask
    nblk = S // bs
    N = B * nblk + 1
    spec = SimpleNamespace(num_layers=1, num_kv_heads=Hkv, head_dim=Dh)
    quant = {"bf16": False, "int8": "int8", "int4": "int4"}[cache]
    entry = pa.init_block_pool(spec, N, bs, quantized=quant, device=dev)[0]
    for name in ("k", "v"):
        x = torch.randn((N - 1, bs, Hkv, Dh), generator=gen, device=dev)
        if cache == "bf16":
            entry[name][1:] = x.to(torch.bfloat16)
            continue
        vals, sc = (da.quantize_kv if cache == "int8" else quantize_kv_int4)(x)
        entry[name][1:] = vals.transpose(1, 2)
        entry[f"{name}_scale"][1:] = sc.transpose(1, 2)
    perm = torch.randperm(N - 1, generator=gen, device=dev)[: B * nblk] + 1
    entry["tbl"] = perm.reshape(B, nblk).to(torch.int32).contiguous()
    return q, entry, mask


def run_split(gen, reps, name, cache, K):
    import torch

    from bcg_tpu_torch.ops import decode_attention as da, paged_attention as pa

    q, kv, mask = split_inputs(gen, cache, K)
    scale = 128 ** -0.5
    B, Kq, H, Dh = q.shape
    if cache == "dense-bf16":
        launch, plain = da.chunk_decode_attention_cuda, da.chunk_decode_attention_plain
        call = lambda: launch(q, *kv, mask, scale)   # noqa: E731
        ref = plain(q, *kv, mask, scale)
        plan = da.chunk_split_plan(q, kv[0], mask)
        split_ref = da.decode_attention_split_plain(q, *kv, mask, scale, *plan)
        S, Hkv = kv[0].shape[1], kv[0].shape[2]
        byts = mask.any(1).sum().item() * Hkv * 2 * Dh * 2
    elif cache == "dense-int8":
        qq, m = (q[:, 0], mask[:, 0]) if K == 0 else (q, mask)
        launch, plain = getattr(da, f"{name}_cuda"), getattr(da, f"{name}_plain")
        call = lambda: launch(qq, *kv, m, scale)   # noqa: E731
        ref = plain(qq, *kv, m, scale)
        plan = da.int8_split_plan(qq, kv[0], m)
        split_ref = da.decode_attention_split_plain(qq, kv[0], kv[1], m, scale, *plan,
                                                    k_scale=kv[2], v_scale=kv[3])
        Hkv, S = kv[0].shape[1], kv[0].shape[2]
        slots = mask.any(1).sum().item()
        byts = slots * Hkv * (2 * Dh + 8)
    else:
        m = mask[:, 0] if K == 0 else mask
        step = K == 0
        launch = pa.paged_decode_attention_cuda if step else pa.paged_chunk_attention_cuda
        plain = pa.paged_decode_attention_plain if step else pa.paged_chunk_attention_plain
        call = lambda: launch(q, kv, m, scale)   # noqa: E731
        ref = plain(q, kv, m, scale)
        plan = pa.split_plan(q, kv, mask)
        split_ref = pa.paged_attention_split_plain(q, kv, m, scale, *plan)
        Hkv, bs = pa.num_kv_heads(kv), pa.block_size(kv)
        nblk = kv["tbl"].shape[1]
        S = nblk * bs
        live_cols = mask.reshape(B, Kq, nblk, bs).any(3).any(1)
        blocks = torch.unique(kv["tbl"][live_cols]).numel()
        per_pos = {"bf16": 2 * Dh * 2, "int8": 2 * (Dh + 4), "int4": 2 * (Dh // 2 + 2)}[cache]
        byts = blocks * bs * Hkv * per_pos + 4 * kv["tbl"].numel()
    out = call()
    torch.cuda.synchronize()
    out4, ref4, split4 = (t[:, None] if t.dim() == 3 else t for t in (out, ref, split_ref))
    rel_row, rel_head = _rel(out4, ref4, (1, 3))
    split_row, split_head = _rel(out4, split4, (1, 3))
    ms, gms = _event_ms(call, reps), _graph_ms(call, reps)
    bms, by = _bound(byts + 2 * 2 * q.numel() + mask.numel(), 4 * Dh * H * mask.sum().item())
    return dict(name=name, shape=[B, Kq, H, Hkv, S], split=list(plan), rel_row=rel_row,
                rel_head=rel_head, split_rel_row=split_row, split_rel_head=split_head, ms=ms,
                graph_ms=gms, bound_ms=bms, bound_by=by)


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
    runs = [run_decode, run_prefill] + [
        lambda g, reps, f=f: run_split(g, reps, *f) for f in SPLIT_FORMS]
    for run in runs:
        r = run(gen, args.reps)
        ok &= r["rel_row"] <= REL_ROW_TOL and r["rel_head"] <= REL_HEAD_TOL
        if "split_rel_row" in r:
            ok &= r["split_rel_row"] <= REL_ROW_TOL and r["split_rel_head"] <= REL_HEAD_TOL
        print(json.dumps(r), flush=True)
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
