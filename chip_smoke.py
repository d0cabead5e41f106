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
4. Nine game paths on ``bcg-tpu/bench-8b`` (Qwen3-8B widths, 36 layers
   (P9: 12; P2-P8 but P9: 4), random weights made once on the
   card from a seed and
   shared by every engine through ``TorchEngine(params=...)``), each a
   full 8 honest + 2 Byzantine game through
   ``BCGSimulation(config, engine=TorchEngine(...))``.
   Every kernel's launch count (and the call count of the plain paged
   attention versions) is set to 0 just before a path and read just
   after; each kernel of the path must be > 0, the plain paged calls 0,
   and no row may fail its schema.

   * P1: the default engine (bf16 cache, plain loop), 1 round, timed
     and captured, then profiled (5, 6).
   * P2: int8 cache, fast-forward loop, compact JSON, 1 round, timed
     and captured, then profiled; its line adds the decode steps per
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
   P8 and P9 quantize their own copies of the shared bf16 weights.  P9
   runs the first 12 of 36 layers, P2-P8 the first 4 (the script's time
   limit; their lines print ``layers``).
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
6. Capture: during the path's counted game (P1-P7; a copy is made only
   when a call is larger than every earlier one, a few a game, so the
   timed games pay milliseconds for it; P9: the profiled round, whose
   wall time the busy share does not use, the copies' bytes printed in
   its profile line), with each kernel launcher wrapped to keep a device
   copy of the inputs of its largest call, with their strides (k/v are
   views into the KV cache).
7. Kernel phase: each of the thirteen kernel forms against its plain
   PyTorch version on its captured inputs (the sampler, B2, on mixed
   greedy / sampled rows at top_p 1.0 and 0.9, at P1's 10 rows and at
   ``SAMPLER_BIG_BATCH`` rows, P1's tiled past one wave of clusters, token
   for token; its cluster plan printed; event- and graph-timed at both
   top_p values; ``--save-sampler-inputs FILE`` also writes P1's call for
   ``python -m bcg_tpu_torch.tools.sampler_kernel``), with CUDA-event timings
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call (B1 and B3a also print the ratio of the
   kernel's time to that call's); and the bound (bytes at 3.35 TB/s, int8
   values and f32 scales counted as stored, or operations at 989
   TFLOP/s).  B5 (the W4A16 matmul) runs at P9's largest call (the LM
   head, M = 10) and at one captured weight of each layer shape with
   M = 1, 10, 50 and 256, held by relative L2 error per output row, with
   ``torch._weight_int4pack_mm`` over the same int4 weight (the library
   call of B5's function, converted once outside the timing, its error
   against the plain version printed; a shape this torch build refuses
   prints the error and keeps ``library_ms`` None) and ``torch.matmul``
   over the already dequantized bf16 weight timed beside it (another
   function: the bf16 product int4 has to beat); and at each layer shape
   the route's crossover: B5 against the weight dequantized whole and
   one bf16 product, the dequantization counted, at 16 to 256 rows
   (``quantize.W4_KERNEL_MAX_ROWS`` sits where the second starts to
   win).  Its times come from CUDA graphs of calls (``graph_ms``), as do
   B3a's and its SDPA yardstick's (a call of tens of microseconds, whose
   event-timed single call, printed beside it, counts the wrapper's host
   time).  The split kernels — B3a, B3a-chunk, the two int8 forms (B3b)
   and the six paged forms (B4) — are also held to the plain version of
   their split arithmetic at the plan the kernel used (``split``: the
   split count and positions per split, also in the kernels line), and
   B3a-chunk, the int8 and the paged forms print a ``graph_ms`` (a CUDA
   graph of calls over enough copies of the captured inputs to read twice
   the L2) beside their event-timed ``ms``, both also in the kernels
   line.  Attention errors are
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
8. P10 (after the nine paths, before the kernel phase): checkpoint
   loading and the observability plane at full width and depth.  The
   shared weights are written as an HF-layout checkpoint with the port's
   safetensors writer (HF names, ``[out, in]`` projections, BF16, shards
   of at most 5 GB and their index) under ``build/p10`` (the free disk is
   checked first; a disk too small cuts the depth, printed, and the game
   is then held to the same game over the shared weights cut alike),
   found through ``BCG_TPU_CHECKPOINT_DIR`` and loaded onto the card by
   ``models/loader.load_checkpoint_params`` (``load P10:`` shards, bytes,
   seconds, GB/s; every leaf ``torch.equal`` to the shared one).  Then
   P1's game over the loaded weights with ``BCG_TPU_TRACE``,
   ``BCG_TPU_HOSTSYNC``, ``BCG_TPU_COMPILE_OBS``, ``BCG_TPU_HLO_CENSUS`` and
   ``BCG_TPU_GAME_EVENTS`` on: its decisions, votes and statistics must
   equal P1's (``game P10:``), and ``obs P10:`` prints the host syncs a
   round by seam (with the source lines of the synchronizing operations
   outside the seams), the census of one decode step (the card's kernels
   by kind beside the wrappers' launches and calls: B3a 36 and B2 1, both
   ways), the ledger's ``params`` charge beside ``param_bytes`` and
   ``torch.cuda.memory_allocated``, the spans and the five largest, and
   the number of game-event lines.  The game's trace
   (``BCG_TPU_TRACE_OUT``), event stream, compile-cause stream and metric
   shards (``BCG_TPU_METRICS_SHARD_DIR``, run ``p10``) are kept under
   ``build/reports`` for the reports phase.  ``census P10:`` holds the
   decode step's census to the ``cuda`` section of
   ``bcg_tpu_torch/tools/census_baseline.json`` (36 layers, exact counts;
   ``--save-census FILE`` writes the census, the input of ``python -m
   bcg_tpu_torch.tools.census_gate --update-cuda FILE``); a finding, or a
   depth cut by a small disk, fails the run in the reports phase.  Then
   P13 serves the same checkpoint,
   which is deleted after it: the directory is renamed to a
   ``Qwen/Qwen3-8B`` snapshot (bench-8b's registered widths), given the
   shipped ChatML tokenizer set (``bcg_tpu_torch/models/
   fixture_tokenizers/chatml``, a byte-level BPE of 448 entries) and a
   ``config.json``, and ``TorchEngine(model_name="Qwen/Qwen3-8B")`` boots
   from it through ``find_checkpoint_dir``, ``load_checkpoint_params`` and
   ``tokenizer_for_model`` — the port's own ``tokenizer.json`` reader, no
   fallback (P10's engine and loaded copy freed first: two weight copies
   at most).  One sampled round of P1's game, untimed (``game P13:`` the
   tokenizer's length beside the model's vocabulary, the share of logit
   ids the token DFA can reach, prompt tokens per row beside the byte
   tokenizer's on the same prompts, decode steps, failed and unparsed rows
   (0), the prompts' encode/decode round trip, peak memory, launches); its
   B1, B3a and B2 calls captured and held in the kernel phase as
   ``flash_prefill@P13``, ``decode_attention@P13`` and
   ``guided_sampler@P13`` (B2 over a 151,936-wide row of which the DFA
   reaches a few hundred ids).
9. P11 (after P10, before the kernel phase): the serving tier at full
   width and depth.  Four of P1's games (seeds 0-3, 1 round, P1's engine
   config) played at once through ``serve.run_serving_simulations`` and
   ``api.run_simulation`` over one ``TorchEngine`` on the shared weights
   behind ``ServingEngine`` (the continuous-batching scheduler, default
   linger; its supervisor's factory builds over the same weights).  The
   counts are set to 0 just before and read just after; B1, B3a and B2
   must launch, the plain paged versions not, no row may fail, and at
   least one dispatch must merge games.  The kernels' inputs are captured
   at their largest (merged) calls and held in the kernel phase as
   ``flash_prefill@P11``, ``decode_attention@P11`` (one split when B * Hkv
   reaches two blocks an SM) and ``guided_sampler@P11``.  ``game P11:``
   prints the games, decisions, wall and decisions/s, the dispatches and
   rows per dispatch, the derived row cap, the scheduler's queue-wait,
   device and end-to-end quantiles, failed rows, peak memory and
   launches.  Then a chaos run of two games (``BCG_TPU_CHAOS``: a crash on
   the first dispatch, a hang past ``BCG_TPU_SERVE_WATCHDOG_S`` on the
   third): both complete, the scheduler reads one engine rebuild and two
   retried dispatches, and the condemned call's thread is joined before
   the phase ends (``chaos P11:``).  The alert plane is on in the chaos
   run (``BCG_TPU_ALERTS``, its stream under ``build/reports``); two quiet
   evaluations after it resolve what fired.
   Then the reports phase: the five report scripts (``scripts/
   {consensus,trace,compile,fleet,alert}_report.py``, each run as a
   process) over P10's files and P11's alert stream.  ``reports P10:``
   prints each one's exit code and headline figures and whether they
   agree with P10's and P11's own: the consensus report's rounds with the
   game's, the trace report's host syncs with ``host_syncs_total`` and its
   census row with ``kernels_per_step``, the compile report's entries with
   the port's seams, the fleet report's one shard, the alert report's
   transitions with the alert engine's.  A non-zero exit, a disagreement
   or a census finding fails the run.
10. P12 (after P11, before the kernel phase): the fused mega-round on
   P1's engine over the shared weights, with the host-sync auditor (the
   card's sync debug mode on) and compile accounting on.  Three fused
   rounds (10 agents, range 0-50, one Byzantine, state carried) are each
   held to ``batch_generate_json`` at temperature 0 over the same
   template prompts (0 decision and 0 vote mismatches), each must make
   exactly one host sync (the ``round_readback`` seam) and rounds 2-3 no
   compile record (``megaround P12:``, with decode steps a round and the
   warm fused round's wall beside the warm lockstep pair's).  Then an
   8 honest + 2 Byzantine game, 3 rounds, ``AgentConfig(megaround=True)``
   through ``BCGSimulation`` (counts set to 0 just before, read just
   after; the lockstep fallback's warning is an error; every round fused,
   every proposal and vote parsed, one host sync a round), its B1, B3a
   and B2 calls captured and held in the kernel phase as
   ``flash_prefill@P12``, ``decode_attention@P12`` and
   ``guided_sampler@P12`` (``game P12:``).
11. The mesh paths, P14 and P15 (after P12, before the kernel phase), on
   the one card as three worlds of two ranks, one a mesh shape, both
   ranks on ``cuda:0`` over gloo (NCCL refuses two ranks on one device;
   every gloo collective of a CUDA tensor is staged through pinned host
   memory), each started once by ``parallel.distributed.spawn_world``
   with a wall limit: ``tp=2`` (mesh 1x2x1), ``sp=2`` (1x1x2) and
   ``dp=2`` (2x1x1).  Each world runs its arms one after another
   (``MESH_WORLDS``):

   * P14, the default engine: ``P14 tp``, ``P14 sp`` and ``P14 dp``
     (``spmd_exchange`` on);
   * P15, every other engine the port serves on one
     device, each the engine of the path it mirrors: ``tp-w8-ff`` (P8:
     W8A8 weights, int8 cache, fast-forward, compact JSON), ``tp-w4-paged-
     spec`` (P9 x P7: W4A16 weights through B5, a paged int8 pool,
     speculative), ``sp-int8-ff`` (P2), ``sp-spec`` (P3), ``dp-paged``
     (P5, two rounds) and ``served`` (P1's engine behind
     ``ServingEngine``: rank 0 leads, rank 1 follows; two greedy games).

   Each rank draws bench-8b's weights through
   ``loader.init_random_params_sharded`` (seed 0, its slices only; the
   quantized arms through the sharded quantizer, each full leaf quantized
   and then sliced) and keeps ``MESH_DEPTH`` (4) of 36 layers; each
   rank's leaf parts must checksum to the slices of the parent's shared
   weights (quantized whole first).  Each arm's reference is the
   parent's one-rank engine of its config (P14's arms share P1's) over
   the same layers: it plays one greedy round of the 8H+2B game, and its
   tokens and the speculative verify's accepted counts are kept.  Each
   arm plays the same round fed them (teacher-forced: each sampler call
   still runs B2 on the arm's own logits, then takes the reference's
   token; each verify takes the reference's count), so a near tie
   flipped by another order of sums cannot change what follows.  Every
   rank's game must equal the reference's (decisions, votes, the
   statistics), with no failed row; the logits of the prefill and of
   decode steps 1, 2, 4, ..., 256 of each guided loop (gathered over the
   vocabulary under tp; each rank's rows under dp) must lie within
   ``P14_LOGIT_TOL`` relative L2 a row of the reference's (the live rows
   whose own greedy token or accepted count differed are counted as
   ``flips``); each kernel the arm reaches must launch on every rank; a
   dp arm's two paged pools must be equal byte for byte.  The served arm
   is held the other way round: no failed row, a dispatch merging both
   games' rows split over the ranks, both ranks' outputs identical, and
   rank 0's dispatches replayed through the one-rank engine fed the
   arm's tokens, its logits held to the arm's as above.  Rank 0 of the tp
   world captures B1, B3a and B2 in ``P14 tp`` (16 q and 4 kv heads a
   rank; B2 over the gathered ``[10, 151936]`` logits), and B5 (its LM
   head at N 75,968 and each layer shape, w_down at K 6144), B3b-chunk
   and B4 int8 chunk at 4 kv heads in the tp P15 arms, held in the
   kernel phase as ``flash_prefill@P14``, ``decode_attention@P14``,
   ``guided_sampler@P14``, ``w4a16_matmul@P15``,
   ``chunk_decode_attention_int8@P15`` and ``paged_chunk_attention_int8@P15``.
   Prints ``game P14 <arm>:`` / ``game P15 <arm>:`` (failed rows, the
   logits' spread by held call, flips, launches per rank, a steady step's
   collectives by kind, how many were staged and its time, peak memory and
   weight bytes per rank, the arm's wall).  A rank's failure or a world
   past its limit fails the run with the rank's output.
12. P16 (after the mesh paths, before the kernel phase; the shared
   weights freed first): the cooperative scale sweep through its own entry
   point, ``tools.scale_sweep.run`` with ``--device cuda --ranks 2
   --agents 10 --rounds 1 --seed 0 --model bcg-tpu/bench-8b
   --max-model-len 0 --decide-tokens 0 --vote-tokens 0``: a world of two
   ranks on ``cuda:0`` over gloo (dp 2, 5 agents' rows a rank, the SPMD
   exchange one staged ``all_gather`` a round), each rank making
   bench-8b's whole tree at full width and depth from seed 0 and playing
   the one 8H+2B game through the sweep's cooperative mode, rank 0
   recording it.  Each rank runs under ``p16_probe`` (the kernels' counts
   set to 0 before its sweep and read after, around
   ``tools.coop_probe.probe``).  Held: both ranks exit 0; the JSON line
   has exactly the JAX script's keys, ``devices``, ``dp`` and
   ``spmd_mesh_dp`` 2, one round, ``dp_batches`` >= 1 and rates above 0;
   0 failed rows on each rank; one manifest (rank 0's) with the fleet
   identity in its header and one completed ``job_end``; one ``game_end``;
   the ranks' game digests, engine calls and weights checksums equal; the
   recorded deliveries equal the dense ``parallel.game_step.masked_exchange``
   over the recorded proposals and the topology; B1, B3a and B2 launched
   on each rank; each rank's ``torch.cuda.max_memory_allocated`` from its
   engine's boot until its weights are made at most 1.02x
   ``loader.boot_peak_report``'s peak for bench-8b on the dp-2 mesh.
   Prints ``game P16:`` (rounds, decisions/s and wall, rows and failed
   rows, launches a rank, a round's collectives by kind and how many were
   staged, the exchange check, peak and weight GB a rank) and ``boot
   P16:`` (the measured boot peaks beside the report's).
13. Prints the ``kernels`` JSON line and, last, the ``{"ok": true, ...}``
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
# The sampler's second batch: P1's captured rows tiled past one wave of
# clusters (B2 is compared token for token, no tolerance).
SAMPLER_BIG_BATCH = 150
MODEL = "bcg-tpu/bench-8b"
DEVICE = "cuda"
# Blocks of 16 tokens in each paged path's pool: 19.3 GB of bf16, 10.0 GB
# of int8 and 5.0 GB of int4 at bench-8b, room for a 10-row batch at the
# longest window plus two rounds of radix-resident prompts.
PAGED_POOL_BLOCKS = 8192
# Files the options ask for (main fills it).
SAVE = {"census": None}


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


def fmt(x) -> str:
    return "None" if x is None else f"{x:.4g}"


def cold_graph_ms(launch, args, nbytes: int) -> float:
    """``graph_ms`` of ``launch(*args)`` over ``args`` and enough device
    copies of them (``keep``; at most 8 in all) that the graph's calls
    read more than twice the 50 MB L2 (``nbytes``: what one call reads),
    so each call finds its cache cold, as a decode step does."""
    n = max(1, min(8, -(-100_000_000 // max(nbytes, 1))))
    sets = [args] + [tuple(keep(a) for a in args) for _ in range(n - 1)]
    return graph_ms([lambda a=a: launch(*a) for a in sets], max(20, n))


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


def keep(a, device=None):
    """A copy of ``a`` with its strides (a KV-cache view keeps the full
    cache's batch stride, as the kernels read it in the game), on
    ``device`` (default: ``a``'s); a paged entry through
    :func:`keep_entry`."""
    import torch

    if isinstance(a, dict):
        a = keep_entry(a) if "tbl" in a and device is None else a
        return a if device is None else {k: keep(v, device) for k, v in a.items()}
    if not torch.is_tensor(a):
        return a
    out = torch.empty_strided(a.size(), a.stride(), dtype=a.dtype, device=device or a.device)
    return out.copy_(a)


def move_inputs(inputs, device):
    """Every path's captured inputs (``Capture.inputs()`` by path) copied
    to ``device``, strides kept; the originals are dropped."""
    return {path: {name: tuple(keep(a, device) for a in args) for name, args in got.items()}
            for path, got in inputs.items()}


class Capture:
    """Wraps the launchers of the kernel forms ``names`` to keep a copy
    (``keep``; on the card, or on ``device``) of the inputs of each one's
    largest call: the shapes and data the served path gives it.  Only a
    call strictly larger than the kept one is copied (``copied_bytes`` sums
    the copies).  B5 keeps one call per weight shape (its largest), under
    ``("w4a16_matmul", q4 shape)``; its largest call of all is kept under
    ``"w4a16_matmul"``."""

    def __init__(self, names, device=None):
        self.names = tuple(names)
        self.device = device
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
                        kept = tuple(keep(a, self.device) for a in args)
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
# profiled), and the kernel forms it runs, whose inputs are captured in
# the counted game (or with ``capture_in_profile`` in the profiled round;
# ``capture_forms``: the ones captured, if not all; ``capture=False``:
# none; ``depth``: the layers kept, if not all).  P1 and P2 play one
# round, P5 two (its second extends the first's radix chains).  P9 runs a
# third of the layers, since P14 joined; P3, P4, P6 and P7 (the untimed
# paths: their kernels' calls have the same shapes at any depth) and P8
# run 4 since P15 joined, and P2 and P5 (12 from P14's slice) since P16
# joined: the script's time limit is shared by all its paths.
PATHS = {
    "P1": dict(engine={}, rounds=1, timed=True,
               kernels=("flash_prefill", "decode_attention", "guided_sampler")),
    "P2": dict(engine=dict(kv_cache_dtype="int8", decode_fast_forward=True,
                           guided_compact_json=True), rounds=1, timed=True, depth=4,
               kernels=("flash_prefill", "chunk_decode_attention_int8", "guided_sampler")),
    "P3": dict(engine=dict(spec_decode=True), rounds=1, timed=False, depth=4,
               kernels=("flash_prefill", "chunk_decode_attention", "guided_sampler")),
    "P4": dict(engine=dict(kv_cache_dtype="int8"), rounds=1, timed=False, depth=4,
               kernels=("flash_prefill", "decode_attention_int8", "guided_sampler")),
    "P5": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS), rounds=2,
               timed=True, depth=4,
               kernels=("flash_prefill", "paged_decode_attention_bf16", "guided_sampler")),
    "P6": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS,
                           kv_cache_dtype="int4", decode_fast_forward=True,
                           guided_compact_json=True), rounds=1, timed=False, depth=4,
               kernels=("flash_prefill", "paged_chunk_attention_int4", "guided_sampler")),
    "P7": dict(engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS,
                           kv_cache_dtype="int8", spec_decode=True), rounds=1, timed=False,
               depth=4,
               kernels=("flash_prefill", "paged_chunk_attention_int8", "guided_sampler")),
    # The weight-quantized paths: each engine quantizes its own copy of the
    # shared bf16 weights.  P8 is the JAX bench's default 8B path (int8
    # weights, int8 KV, fast-forward, compact JSON; bench.py:1058-1093),
    # timed and profiled; P9 int4 weights over the default engine, timed,
    # profiled, B5's inputs captured.
    "P8": dict(engine=dict(quantization="int8", kv_cache_dtype="int8",
                           decode_fast_forward=True, guided_compact_json=True), rounds=1,
               timed=True, capture=False, depth=4,
               kernels=("flash_prefill", "chunk_decode_attention_int8", "guided_sampler")),
    "P9": dict(engine=dict(quantization="int4"), rounds=1, timed=True, depth=12,
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

def cut_depth(params, depth):
    """The model spec and the shared weights cut to the first ``depth``
    layers (the tree shares the kept leaves)."""
    import dataclasses

    from bcg_tpu_torch.models.configs import spec_for_model

    spec = dataclasses.replace(spec_for_model(MODEL), num_layers=depth)
    return spec, {n: t for n, t in params.items()
                  if not n.startswith("layers.") or int(n.split(".")[1]) < depth}


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

    from bcg_tpu_torch.obs.hlo import kernel_kind

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
        kind = kernel_kind(key)
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
# Each path's counted game: (decisions by round, votes by round, statistics).
GAMES = {}


def play_recorded(sim):
    """``sim.run()``, keeping each round's votes as the round closes:
    (statistics, decisions by round, votes by round)."""
    votes = []
    close = sim._advance_and_record

    def record(round_num, agent_votes):
        votes.append((round_num, dict(agent_votes)))
        return close(round_num, agent_votes)

    sim._advance_and_record = record
    stats = sim.run()
    return stats, [(r.round_num, dict(r.agent_values)) for r in sim.game.rounds], votes


def phase_path(path, params):
    """Play one game path on a fresh engine over the shared weights.
    Returns its launch counts and the captured inputs of its kernels."""
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    conf = PATHS[path]
    cfg = game_config(conf["rounds"], **conf["engine"])
    spec = None
    if "depth" in conf:
        spec, params = cut_depth(params, conf["depth"])
    t0 = time.perf_counter()
    engine = TorchEngine(cfg.engine, device=DEVICE, params=params, spec=spec)
    torch.cuda.synchronize()
    boot_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    capture = conf.get("capture", True)
    forms = conf.get("capture_forms", conf["kernels"])
    in_profile = capture and conf.get("capture_in_profile", False)
    cap = Capture(forms) if capture and not in_profile else None
    try:
        zero_counts()
        t0 = time.perf_counter()
        sim = BCGSimulation(cfg, engine=engine)
        stats, decisions_by_round, votes = play_recorded(sim)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        plain_calls = plain_paged_calls()
    finally:
        if cap is not None:
            cap.restore()
    peak = torch.cuda.max_memory_allocated()
    GAMES[path] = (decisions_by_round, votes, stats)
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
    if spec is not None:
        line.update(layers=spec.num_layers)
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
        profiled = phase_profile(path, engine, forms if in_profile else ())
        cap = profiled if in_profile else cap
    torch.cuda.synchronize()
    engine.shutdown()
    del engine, sim
    torch.cuda.empty_cache()
    return counts, cap.inputs() if cap is not None else {}


# P10: the observability flags it turns on, the hub's shard limit, and the
# free disk it leaves beside the checkpoint.
P10_FLAGS = {"BCG_TPU_TRACE": "1", "BCG_TPU_HOSTSYNC": "1", "BCG_TPU_COMPILE_OBS": "1",
             "BCG_TPU_HLO_CENSUS": "1"}
MAX_SHARD_BYTES = 5 * 10**9
DISK_MARGIN_BYTES = 2 << 30
# The files the report scripts read: P10's game-event stream, trace,
# compile-cause stream and metric shards, and the alert stream of P11's
# chaos run (a plain game starts no alert plane; the serving scheduler
# does).  They wait under REPORTS_DIR until the reports phase.
REPORTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "reports")
REPORT_FILES = {"events": "events.jsonl", "trace": "trace.json",
                "compile_events": "compile.jsonl", "shards": "shards",
                "alerts": "alerts.jsonl"}
P10_RUN_ID = "p10"
# Figures of P10 and of P11's alert plane that the reports must agree with.
P10_OBS = {}


def report_file(key: str) -> str:
    return os.path.join(REPORTS_DIR, REPORT_FILES[key])


def obs_reset():
    """Make the observability modules read the environment again (each
    reads its flags once); closes the trace's, streams' and shards' files."""
    from bcg_tpu_torch.obs import (alerts, compile as obs_compile, fleet, game_events, hlo,
                                   hostsync, tracer)

    for fn in (tracer.reset, hostsync.reset, obs_compile.reset, hlo.reset,
               game_events.reset_sink, fleet.reset, alerts.reset):
        fn()


def hf_order(params):
    """The leaves in the order a hub checkpoint lists them (the JAX
    fixture's order: top leaves, then each layer's in the loader's map)."""
    from bcg_tpu_torch.models import loader

    names = [n for n in loader._TOP_MAP if n in params]
    n_layers = 1 + max(int(n.split(".")[1]) for n in params if n.startswith("layers."))
    for i in range(n_layers):
        names += [f"layers.{i}.{leaf}" for leaf in loader._LAYER_MAP
                  if f"layers.{i}.{leaf}" in params]
    return names


def write_hf_checkpoint(params, out_dir, max_shard_bytes=MAX_SHARD_BYTES):
    """``params`` (bf16 leaves on the card) as an HF-layout checkpoint with
    the port's safetensors writer: HF names, ``[out, in]`` projections,
    BF16 storage, shards of at most ``max_shard_bytes`` named and indexed
    as ``bcg_tpu/models/hf_fixture.py:280-300`` lays them out.  Returns
    (shards, bytes)."""
    from bcg_tpu_torch.models import loader, safetensors_np

    os.makedirs(out_dir, exist_ok=True)
    shards, size = [[]], 0
    for name in hf_order(params):
        nbytes = params[name].numel() * params[name].element_size()
        if size and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += nbytes
    index = {"metadata": {"total_size": 0}, "weight_map": {}}
    for si, shard in enumerate(shards, start=1):
        fname = ("model.safetensors" if len(shards) == 1
                 else f"model-{si:05d}-of-{len(shards):05d}.safetensors")
        items = []
        for name in shard:
            t = params[name]
            items.append((loader.hf_name(name),
                          t.t() if name.split(".")[-1] in loader._TRANSPOSED else t))
            index["weight_map"][items[-1][0]] = fname
        index["metadata"]["total_size"] += safetensors_np.save_file(
            items, os.path.join(out_dir, fname))
    if len(shards) > 1:
        with open(os.path.join(out_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(index, f, indent=2)
    return len(shards), index["metadata"]["total_size"]


def phase_p10(params):
    """P10: checkpoint loading and the observability plane at bench-8b.
    The shared weights are written as an HF-layout checkpoint under
    ``build/``, found through ``BCG_TPU_CHECKPOINT_DIR`` and loaded onto the
    card (every leaf held bit-equal to the shared one), then P1's game is
    played over the loaded weights with the tracer, the host-sync auditor,
    compile accounting, the launch census and the game-event stream on: its
    decisions, votes and statistics must be P1's.  Prints the ``load P10``,
    ``game P10`` and ``obs P10`` lines; deletes the checkpoint."""
    import dataclasses
    import shutil

    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import find_checkpoint_dir, load_checkpoint_params
    from bcg_tpu_torch.obs import compile as obs_compile, fleet, hlo, hostsync, ledger, tracer
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    spec = spec_for_model(MODEL)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "p10")
    out_dir = os.path.join(root, MODEL.replace("/", "--"))
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # The depth the disk holds: the whole model, else as many layers as fit.
    layer_bytes = sum(t.numel() * t.element_size() for n, t in params.items()
                      if n.startswith("layers.0."))
    top_bytes = sum(t.numel() * t.element_size() for n, t in params.items()
                    if not n.startswith("layers."))
    free = shutil.disk_usage(root).free - DISK_MARGIN_BYTES
    depth = min(spec.num_layers, max(0, (free - top_bytes) // layer_bytes))
    if depth < 1:
        fail(f"P10: {free + DISK_MARGIN_BYTES} bytes free on disk, not one layer's room")
    if depth < spec.num_layers:
        spec, params = cut_depth(params, depth)
    print(f"P10: {shutil.disk_usage(root).free} bytes free on disk; depth {depth} of "
          f"{spec_for_model(MODEL).num_layers} layers", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_shards, nbytes = write_hf_checkpoint(params, out_dir)
    write_s = time.perf_counter() - t0
    os.environ["BCG_TPU_CHECKPOINT_DIR"] = root
    try:
        found = find_checkpoint_dir(MODEL)
        if found != out_dir:
            fail(f"P10: find_checkpoint_dir gave {found!r}, not {out_dir!r}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_checkpoint_params(spec, MODEL, DEVICE, ckpt_dir=found)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mismatched = [n for n in params if n not in loaded or not torch.equal(loaded[n], params[n])]
        extra = sorted(set(loaded) - set(params))
        print("load P10: " + json.dumps({
            "shards": n_shards, "bytes": nbytes, "write_seconds": write_s,
            "load_seconds": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
            "leaves": len(loaded), "mismatched": mismatched[:5], "extra": extra[:5],
            "device": str(next(iter(loaded.values())).device),
            "files": sorted(os.listdir(found)),
        }), flush=True)
        if mismatched or extra:
            fail(f"P10: loaded leaves differ from the shared weights: {mismatched[:5]} {extra[:5]}")
    finally:
        # The checkpoint stays for P13 (deleted with ``root`` at the end).
        del os.environ["BCG_TPU_CHECKPOINT_DIR"]

    shutil.rmtree(REPORTS_DIR, ignore_errors=True)
    os.makedirs(REPORTS_DIR)
    p10_env = dict(P10_FLAGS, BCG_TPU_GAME_EVENTS=report_file("events"),
                   BCG_TPU_TRACE_OUT=report_file("trace"),
                   BCG_TPU_COMPILE_OBS=report_file("compile_events"),
                   BCG_TPU_METRICS_SHARD_DIR=report_file("shards"), BCG_TPU_RUN_ID=P10_RUN_ID)
    os.environ.update(p10_env)
    obs_reset()
    try:
        cfg = game_config(PATHS["P1"]["rounds"], **PATHS["P1"]["engine"])
        engine = TorchEngine(cfg.engine, device=DEVICE, params=loaded, spec=spec)
        zero_counts()
        t0 = time.perf_counter()
        stats, decisions, votes = play_recorded(BCGSimulation(cfg, engine=engine))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        plain_calls = plain_paged_calls()
        hs = hostsync.summary()
        census = hlo.snapshot().get("decode_loop")
        led = ledger.snapshot()
        spans = tracer.summarize()
        compile_brief = obs_compile.brief()
        # The files whole: the trace exported, the streams drained, the
        # shard flushed and closed.
        tracer.flush()
        fleet.flush_shards()
        fleet.reset()   # the writer's closing flush still stamps run p10
        for name in p10_env:
            del os.environ[name]
        obs_reset()
        if depth == spec_for_model(MODEL).num_layers:
            want = GAMES["P1"]
        else:
            # A cut model: the reference is the same game over the shared
            # weights cut the same way, without the observability flags.
            ref_engine = TorchEngine(cfg.engine, device=DEVICE, params=params, spec=spec)
            ref_stats, ref_dec, ref_votes = play_recorded(BCGSimulation(cfg, engine=ref_engine))
            ref_engine.shutdown()
            want = (ref_dec, ref_votes, ref_stats)
        same = (decisions, votes, stats) == want
        print("game P10: " + json.dumps({
            "rounds": stats["total_rounds"], "game_seconds": wall,
            "failed_rows": engine.failed_rows, "total_rows": engine.total_rows,
            "decode_steps": engine.total_decode_steps,
            "launches": {k: counts[k] for k in PATHS["P1"]["kernels"]},
            "plain_paged_calls": plain_calls,
            "same_as": "P1" if depth == spec_for_model(MODEL).num_layers else "cut reference",
            "decisions_votes_statistics_equal": same,
        }), flush=True)
        if not same:
            fail("P10: the game over the loaded checkpoint differs from "
                 f"{'P1' if depth == spec_for_model(MODEL).num_layers else 'its reference'}: "
                 f"decisions {decisions} votes {votes} against {want[0]} {want[1]}")

        rounds = hs["rounds"]["count"]
        if census is None:
            fail("P10: the launch census recorded no decode step")
        with open(report_file("events")) as f:
            event_lines = sum(1 for _ in f)
        obs = {
            "host_syncs_per_round": {site: n / rounds for site, n in hs["by_site"].items()},
            "host_syncs_total": hs["total"], "rounds": rounds,
            "unexpected_sync_lines": dict(list(hs.get("device_sync_lines", {}).items())[:6]),
            "census_backend": census["backend"],
            "kernels_per_step": census.get("kernels"),
            "wrapper_launches_per_step": census["launches"],
            "wrapper_calls_per_step": census["calls"],
            "census_error": census.get("error"),
            "ledger_params_bytes": led["params_bytes"], "param_bytes": engine._param_bytes,
            "ledger_prefix_cache_bytes": led["prefix_cache_bytes"],
            "ledger_kv_cache_bytes": led["kv_cache_bytes"],
            "ledger_limit_bytes": led["limit_bytes"],
            "memory_allocated": torch.cuda.memory_allocated(),
            "spans": sum(r["count"] for r in spans.values()), "span_names": len(spans),
            "top_spans_ms": {k: r["total_ms"] for k, r in list(spans.items())[:5]},
            "game_event_lines": event_lines,
            "compile": compile_brief,
        }
        print("obs P10: " + json.dumps(obs), flush=True)
    finally:
        for name in p10_env:
            os.environ.pop(name, None)
        obs_reset()
    # The census against the card's pinned step (tools/census_baseline.json,
    # section "cuda"); a finding fails the run in the reports phase.
    from bcg_tpu_torch.tools import census_gate

    findings = census_gate.check_drift({"decode_loop": census}, census_gate.load_baseline(),
                                       "cuda", layers=depth)
    print("census P10: " + json.dumps({
        "entry": "decode_loop", "layers": depth, "section": "cuda",
        "counts": census_gate.flat_counts(census, "cuda"), "findings": findings,
    }), flush=True)
    if SAVE["census"]:
        os.makedirs(os.path.dirname(os.path.abspath(SAVE["census"])), exist_ok=True)
        with open(SAVE["census"], "w") as f:
            json.dump({"layers": depth, "torch_version": torch.__version__,
                       "entries": {"decode_loop": census}}, f, indent=2)
    P10_OBS.update(rounds=stats["total_rounds"], host_syncs_total=hs["total"],
                   census=census, compile=compile_brief, census_findings=findings)
    layers = spec.num_layers
    kern = census.get("kernels") or {}
    checks = {
        "census on the card": census["backend"] == "cuda" and kern,
        f"B3a {layers} a step": (kern.get("decode_attention") == layers
                                 == census["launches"].get("decode_attention")),
        "B2 one a step": kern.get("guided_sampler") == 1 == census["launches"].get("guided_sampler"),
        "every P1 kernel launched": all(counts[k] > 0 for k in PATHS["P1"]["kernels"]),
        "no plain paged calls": plain_calls == 0,
        "no failed rows": engine.failed_rows == 0,
        "ledger params = param_bytes": led["params_bytes"] == engine._param_bytes,
        "host syncs seen": hs["by_site"].get("decode_readback", 0) > 0,
        "spans recorded": "engine.decode" in spans and "round" in spans,
        "game events written": event_lines > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    engine.shutdown()
    del engine, loaded
    torch.cuda.empty_cache()
    if bad:
        shutil.rmtree(root, ignore_errors=True)
        fail(f"P10: {bad}")
    # P13 serves the same checkpoint under a real model's name; the card
    # then holds the shared weights and P13's loaded copy, no third.
    try:
        if depth < spec_for_model(MODEL).num_layers:
            fail(f"P13: needs the full-depth checkpoint; the disk held {depth} layers")
        t0 = time.perf_counter()
        p13 = phase_p13(out_dir, root)
        print(f"phase P13: {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return p13


# The port's own seams of compile accounting (obs/compile.py), besides the
# nvcc_<library> builds.
COMPILE_SEAMS = ("pad_batch", "split_workspace", "sampler_plan", "megaround_prefix",
                 "megaround")


def phase_reports():
    """The five report scripts (``scripts/*_report.py``, run as processes
    by ``bcg_tpu_torch.tools.reports``) over P10's game-event stream,
    trace, compile-cause stream and metric shards and P11's alert stream.
    Prints ``reports P10:``: each script's exit code and headline figures,
    and whether they agree with P10's and P11's own (the consensus
    report's rounds with the game's, the trace report's host syncs with
    the auditor's total and its census row with the card's kernels a
    step, the compile report's entries with the port's seams and its
    cache entries with the observer's, the fleet report's one shard of
    run ``p10``, the alert report's transitions with the alert engine's).
    Fails on a non-zero exit, a disagreement, or a census finding of
    P10's ``census P10:`` line.  Deletes the files."""
    import shutil

    from bcg_tpu_torch.tools import reports

    try:
        results = reports.run_all(**{k: report_file(k) for k in REPORT_FILES})
    finally:
        shutil.rmtree(REPORTS_DIR, ignore_errors=True)
    kern = P10_OBS["census"].get("kernels") or {}
    cons, trace, comp = (results.get(k, {}) for k in
                         ("consensus_report", "trace_report", "compile_report"))
    row = (trace.get("census") or {}).get("decode_loop") or {}
    listed = set(comp.get("entries") or {}) | set(comp.get("cause_entries") or ())
    alert = results.get("alert_report", {})
    agree = {
        "every report exits 0": len(results) == 5 and all(r["rc"] == 0
                                                          for r in results.values()),
        "consensus rounds = the game's": (cons.get("games") == 1
                                          and cons.get("rounds") == P10_OBS["rounds"]),
        "trace host syncs = host_syncs_total": (trace.get("host_syncs")
                                                == P10_OBS["host_syncs_total"]),
        "trace census = kernels_per_step": (bool(kern)
                                            and row.get("step_ops") == sum(kern.values())
                                            and row.get("step_fusions") == kern.get("other")),
        "compile report lists the port's seams": (
            bool(listed) and all(e in COMPILE_SEAMS or e.startswith("nvcc_") for e in listed)
            and comp.get("cache_entries") == P10_OBS["compile"]["cache_entries"]),
        "fleet report merges one shard": (results.get("fleet_report", {}).get("runs")
                                          == {P10_RUN_ID: 1}),
        "alert report = the alert engine": (
            alert.get("fired", 0) >= 1 and alert.get("fired") == P10_OBS["alerts"]["fired"]
            and alert.get("resolved") == P10_OBS["alerts"]["resolved"]),
        "census: no finding against the cuda section": not P10_OBS["census_findings"],
    }
    print("reports P10: " + json.dumps({"reports": results, "agree": agree}), flush=True)
    bad = [k for k, ok in agree.items() if not ok]
    if bad:
        fail(f"reports P10: {bad}; census findings: {P10_OBS['census_findings']}")


# P13: the bench-8b checkpoint of P10, served as a real model would be:
# under the registered name of the model whose widths it has, with a real
# byte-level BPE tokenizer (the shipped ChatML fixture set) read by the
# port's own tokenizer.json reader, found and loaded by the normal entry
# points.  One sampled round of P1's game.
P13_MODEL = "Qwen/Qwen3-8B"


def phase_p13(ckpt_dir, root):
    """P13: ``ckpt_dir`` (P10's 4-shard HF checkpoint of the shared
    weights) becomes a ``Qwen/Qwen3-8B`` snapshot: renamed under ``root``,
    given the shipped ChatML tokenizer set (``models/fixture_tokenizers``)
    and a ``config.json``, and found through ``BCG_TPU_CHECKPOINT_DIR``.
    ``TorchEngine(model_name="Qwen/Qwen3-8B")`` boots from it through
    ``find_checkpoint_dir``, ``load_checkpoint_params`` and
    ``tokenizer_for_model`` (the port's reader: no fallback — a reader
    error fails the run), then plays one sampled round of P1's game (8
    honest + 2 Byzantine, seed 0, prefix caching on), untimed, with B1,
    B3a and B2 captured for the kernel phase (``*@P13``).  The counts are
    set to 0 just before and read just after.  Prints ``game P13``: the
    tokenizer's length beside the model's vocabulary, the share of logit
    ids the token DFA can reach, prompt tokens per row beside the byte
    tokenizer's on the same prompts (P1's template), decode steps, failed
    and unparsed rows (0), whether every prompt round-trips through
    ``encode`` and ``decode``, peak memory and launches.  Returns the
    launch counts and captured inputs."""
    import dataclasses
    import shutil

    import torch

    from bcg_tpu_torch.engine.chat_template import format_chat_prompt
    from bcg_tpu_torch.engine.tokenizer import HFTokenizer
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.models import hf_fixture
    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import find_checkpoint_dir
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    spec = spec_for_model(P13_MODEL)
    bench = spec_for_model(MODEL)
    widths = ("vocab_size", "hidden_size", "num_layers", "num_heads", "num_kv_heads",
              "head_dim", "intermediate_size", "qk_norm", "rope_theta", "rms_eps")
    if any(getattr(spec, w) != getattr(bench, w) for w in widths):
        fail(f"P13: {P13_MODEL}'s registered widths are not {MODEL}'s")
    snap = os.path.join(root, P13_MODEL.replace("/", "--"))
    os.rename(ckpt_dir, snap)
    shipped = hf_fixture.shipped_tokenizer_dir("chatml", hf_fixture.SHIPPED_VOCAB)
    for name in hf_fixture.TOKENIZER_FILES:
        shutil.copyfile(os.path.join(shipped, name), os.path.join(snap, name))
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(hf_fixture._hf_config(spec), f, indent=2)
    forms = PATHS["P1"]["kernels"]
    cfg = game_config(PATHS["P1"]["rounds"], **PATHS["P1"]["engine"])
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine, model_name=P13_MODEL))
    os.environ["BCG_TPU_CHECKPOINT_DIR"] = root
    try:
        found = find_checkpoint_dir(P13_MODEL)
        if found != snap:
            fail(f"P13: find_checkpoint_dir gave {found!r}, not {snap!r}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        engine = TorchEngine(cfg.engine, device=DEVICE)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0
        tok = engine.tokenizer
        if not isinstance(tok, HFTokenizer):
            fail(f"P13: the engine's tokenizer is {type(tok).__name__}, not the port's reader")
        prompts, results = [], []
        call = engine.batch_generate_json

        def recorded(rows, *args, **kw):
            prompts.extend(rows)
            out = call(rows, *args, **kw)
            results.extend(out)
            return out

        engine.batch_generate_json = recorded
        cap = Capture(forms)
        try:
            zero_counts()
            t0 = time.perf_counter()
            stats, decisions, votes = play_recorded(BCGSimulation(cfg, engine=engine))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            cap.restore()
            engine.batch_generate_json = call
        peak = torch.cuda.max_memory_allocated()
    finally:
        del os.environ["BCG_TPU_CHECKPOINT_DIR"]
    texts = [(system, user if isinstance(user, str) else "".join(user))
             for system, user, _ in prompts]
    bpe_tokens = [len(tok.encode(format_chat_prompt(P13_MODEL, s, u))) for s, u in texts]
    byte_tokens = [len(format_chat_prompt(MODEL, s, u).encode("utf-8")) for s, u in texts]
    roundtrip = all(tok.decode(tok.encode(x)) == x for pair in texts for x in pair)
    reachable = sum(1 for b in tok.token_bytes() if b)
    unparsed = sum(1 for r in results if isinstance(r, dict) and "error" in r)
    line = {
        "model": P13_MODEL, "checkpoint": os.path.basename(snap),
        "files": sorted(os.listdir(snap)), "boot_seconds": boot_s,
        "tokenizer": type(tok).__name__, "byte_level": tok._byte_level,
        "tokenizer_len": tok.vocab_size, "model_vocab": spec.vocab_size,
        "dfa_reachable_ids": reachable, "dfa_reachable_share": reachable / spec.vocab_size,
        "rows": len(prompts),
        "prompt_tokens_per_row": {"mean": statistics.mean(bpe_tokens), "min": min(bpe_tokens),
                                  "max": max(bpe_tokens)},
        "byte_tokenizer_tokens_per_row_at_P1": {
            "mean": statistics.mean(byte_tokens), "min": min(byte_tokens),
            "max": max(byte_tokens)},
        "decode_steps": engine.total_decode_steps, "rounds": stats["total_rounds"],
        "decisions_by_round": [d for _, d in decisions],
        "votes_by_round": [v for _, v in votes],
        "failed_rows": engine.failed_rows, "total_rows": engine.total_rows,
        "unparsed_rows": unparsed, "prompts_round_trip": roundtrip,
        "game_seconds": wall, "peak_bytes": peak,
        "launches": {k: counts[k] for k in forms},
        "plain_paged_calls": plain_paged_calls(),
        "capture_copied_bytes": cap.copied_bytes,
    }
    print("game P13: " + json.dumps(line), flush=True)
    checks = {
        "the port's reader serves the checkpoint's tokenizer": line["tokenizer"] == "HFTokenizer",
        "byte-level BPE detected": tok._byte_level,
        "no failed rows": engine.failed_rows == 0 and engine.total_rows > 0,
        "no unparsed rows": unparsed == 0,
        "every prompt round-trips": roundtrip,
        "fewer prompt tokens than the byte tokenizer": sum(bpe_tokens) < sum(byte_tokens),
        "B1, B3a and B2 launched": all(counts[k] > 0 for k in forms),
        "no plain paged calls": line["plain_paged_calls"] == 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    if bad:
        fail(f"P13: {bad}")
    return counts, cap.inputs()


# P11: four of P1's games served at once by one engine behind the
# continuous-batching scheduler (default linger), then a chaos run of two
# games.  The chaos run lingers long enough for both games' calls to merge
# (dispatch 1 their decisions, 2 the retry of that, 3 their votes); its
# watchdog sits above any of its merged calls, and the hang above the
# watchdog, so the engine is rebuilt once, on the third dispatch.
P11_SEEDS = (0, 1, 2, 3)
P11_CHAOS_SEEDS = (0, 1)
P11_CHAOS_LINGER_MS = 500
P11_WATCHDOG_S = 30
P11_HANG_S = 36
P11_CHAOS = f"crash@serve.dispatch:1;hang@serve.dispatch:3:{P11_HANG_S}"


def expandable_segments(on: bool) -> None:
    """Turn the caching allocator's expandable segments on or off (for
    segments made from now on).  P11's 40-row prefill needs ~72 GB of the
    card's 85: with fixed segments, the blocks it frees and asks for again
    at other sizes strand ~11 GB, which the card does not have."""
    import warnings

    import torch

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        torch.cuda.memory._set_allocator_settings(f"expandable_segments:{on}")


def phase_p11(params):
    """P11 (see :func:`p11_runs`) on expandable segments."""
    import torch

    torch.cuda.empty_cache()
    expandable_segments(True)
    try:
        return p11_runs(params)
    finally:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        expandable_segments(False)


def p11_runs(params):
    """P11: the serving tier at bench-8b.  Four games (seeds 0-3, P1's
    engine config) through ``serve.run_serving_simulations`` and
    ``api.run_simulation`` over one ``TorchEngine`` on the shared weights
    behind ``ServingEngine``, the kernels of P1 captured at their largest
    (merged) calls; then two games with a crashed and a hung dispatch,
    which the retry ladder and the supervisor's one rebuild absorb.
    Prints ``game P11`` and ``chaos P11``; returns the served run's launch
    counts and captured inputs."""
    import threading

    import torch

    from bcg_tpu_torch import api
    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.obs import alerts as obs_alerts, counters as obs_counters
    from bcg_tpu_torch.runtime import resilience
    from bcg_tpu_torch.serve import ServingEngine, run_serving_simulations

    cfg = game_config(1, **PATHS["P1"]["engine"])
    forms = PATHS["P1"]["kernels"]

    def build():
        return TorchEngine(cfg.engine, device=DEVICE, params=params)

    def games(seeds):
        return [lambda eng, s=s: api.run_simulation(
            n_agents=10, byzantine_count=2, max_rounds=1, seed=s, engine=eng, config=cfg)
            for s in seeds]

    def counted_rows(engine):
        rows = []
        call = engine.batch_generate_json

        def counted(prompts, temperature=0.8, max_tokens=512):
            rows.append(len(prompts))
            return call(prompts, temperature, max_tokens)

        engine.batch_generate_json = counted
        return rows

    def finished(results, what):
        bad = [r for r in results if isinstance(r, BaseException)]
        if bad:
            fail(f"P11: {what}: a game raised {type(bad[0]).__name__}: {bad[0]}")
        stats = [r["metrics"] for r in results]
        if any(m["total_rounds"] < 1 or len(m) < 40 for m in stats):
            fail(f"P11: {what}: game statistics malformed")
        return stats

    # -- the served run
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engine = build()
    boot_s = time.perf_counter() - t0
    rows = counted_rows(engine)
    serving = ServingEngine(engine, engine_factory=build)
    # Host copies: a 40-row prefill leaves no room on the card for them.
    cap = Capture(forms, device="cpu")
    try:
        zero_counts()
        t0 = time.perf_counter()
        results = run_serving_simulations(engine, games(P11_SEEDS), serving=serving)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        plain_calls = plain_paged_calls()
        snap = serving.stats()
    finally:
        cap.restore()
        serving.scheduler.close()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    stats = finished(results, "served run")
    # A decide and a vote an agent a round, as the profiler counts them
    # (P1's ``decisions``).
    decisions = sum(2 * m["total_agents"] * m["total_rounds"] for m in stats)
    hist = snap.get("hist_ms") or {}
    line = {
        "games": len(stats), "rounds": [m["total_rounds"] for m in stats],
        "decisions": decisions, "game_seconds": wall,
        "agent_decisions_per_sec": decisions / wall, "boot_seconds": boot_s,
        "dispatches": snap["dispatches"], "merged_dispatches": snap["merged_dispatches"],
        "rows_per_dispatch_mean": sum(rows) / max(len(rows), 1),
        "rows_per_dispatch_max": max(rows, default=0), "rows_per_dispatch": rows,
        "row_cap": serving.scheduler.row_cap,
        "queue_wait_ms": hist.get("queue_wait"), "device_ms": hist.get("device"),
        "e2e_ms": hist.get("e2e"), "spans_ms": snap.get("latency_ms"),
        "failed_rows": engine.failed_rows, "total_rows": engine.total_rows,
        "scheduler_failed": snap["failed"], "decode_steps": engine.total_decode_steps,
        "kv_cache_bytes": engine.max_kv_cache_bytes, "peak_bytes": peak,
        "peak_reserved_bytes": peak_reserved, "allocated_before_bytes": held,
        "card_bytes": torch.cuda.mem_get_info()[1],
        "launches": {k: counts[k] for k in forms}, "plain_paged_calls": plain_calls,
        "capture_copied_bytes": cap.copied_bytes,
    }
    print("game P11: " + json.dumps(line), flush=True)
    checks = {
        "every P1 kernel launched": all(counts[k] > 0 for k in forms),
        "no plain paged calls": plain_calls == 0,
        "no failed rows": engine.failed_rows == 0 and snap["failed"] == 0,
        "a dispatch merged games": snap["merged_dispatches"] >= 1 and max(rows) > 10,
    }
    engine.shutdown()
    del engine, serving
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"P11: {bad}")

    # -- the chaos run, with the alert plane on: its stream goes to the
    # reports phase
    env = {"BCG_TPU_SERVE_WATCHDOG_S": str(P11_WATCHDOG_S),
           "BCG_TPU_SERVE_MAX_DISPATCH_RETRIES": "1", "BCG_TPU_CHAOS": P11_CHAOS,
           "BCG_TPU_ALERTS": "1", "BCG_TPU_ALERT_EVENTS": report_file("alerts")}
    os.environ.update(env)
    resilience.reset()
    obs_alerts.reset()
    before = obs_counters.snapshot()
    built = []

    def rebuild():
        fresh = build()
        built.append(fresh)
        return fresh

    torch.cuda.reset_peak_memory_stats()
    engine = build()
    serving = ServingEngine(engine, engine_factory=rebuild, linger_ms=P11_CHAOS_LINGER_MS)
    try:
        t0 = time.perf_counter()
        results = run_serving_simulations(engine, games(P11_CHAOS_SEEDS), serving=serving)
        wall = time.perf_counter() - t0
        snap = serving.stats()
    finally:
        serving.scheduler.close()
        # The condemned call wakes on its abandoned worker thread and runs
        # on the old engine; nothing of it may outlive the phase.
        for t in threading.enumerate():
            if t.name == "bcg-serve-device":
                t.join(timeout=P11_HANG_S + 600)
        left = [t.name for t in threading.enumerate() if t.name.startswith("bcg-serve")]
        # Two quiet cycles resolve what the faults fired; then the alert
        # engine stops and its stream is closed.
        for _ in range(2):
            obs_alerts.evaluate_now()
        alert_engine = obs_alerts.engine()
        alerts = ({"fired": alert_engine.fired, "resolved": alert_engine.resolved,
                   "by_rule": alert_engine.fired_by_rule()}
                  if alert_engine is not None else {"fired": 0, "resolved": 0, "by_rule": {}})
        obs_alerts.reset()
        for name in env:
            os.environ.pop(name, None)
        resilience.reset()
    torch.cuda.synchronize()
    joined_s = time.perf_counter() - t0
    stats = finished(results, "chaos run")
    injected = {k: v for k, v in obs_counters.delta(before).items()
                if k.startswith("chaos.injected")}
    recovery = snap.get("recovery") or {}
    failed_rows = engine.failed_rows + sum(e.failed_rows for e in built)
    print("chaos P11: " + json.dumps({
        "games": len(stats), "rounds": [m["total_rounds"] for m in stats],
        "game_seconds": wall, "seconds_to_join": joined_s, "watchdog_s": P11_WATCHDOG_S,
        "chaos": P11_CHAOS, "engine_rebuilds": recovery.get("engine_rebuilds"),
        "dispatch_retries": recovery.get("dispatch_retries"),
        "recoveries": recovery.get("recoveries"), "engines_built": len(built),
        "dispatches": snap["dispatches"], "scheduler_failed": snap["failed"],
        "failed_rows": failed_rows, "threads_left": left,
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "peak_reserved_bytes": torch.cuda.max_memory_reserved(), **injected,
        "alerts": alerts,
    }), flush=True)
    P10_OBS["alerts"] = alerts
    checks = {
        "one engine rebuild": recovery.get("engine_rebuilds") == 1 and len(built) == 1,
        "one crash and one hang injected": (injected.get("chaos.injected.crash") == 1
                                           and injected.get("chaos.injected.hang") == 1),
        "the crash and the hang retried": recovery.get("dispatch_retries") == 2,
        "no failed rows": failed_rows == 0 and snap["failed"] == 0,
        "no call outlives the phase": not left,
    }
    for e in [engine] + built:
        e.shutdown()
    del engine, built, serving
    torch.cuda.empty_cache()
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail(f"P11 chaos: {bad}")
    return counts, cap.inputs()


# P12: the fused mega-round (ROADMAP A10) on P1's engine: three fused
# rounds held to the lockstep oracle, then a fused game.  The flags on
# while it runs: the host-sync auditor (with the card's sync debug mode)
# and compile accounting.
P12_ROUNDS = 3
P12_FLAGS = {"BCG_TPU_HOSTSYNC": "1", "BCG_TPU_COMPILE_OBS": "1"}
P12_SYNC_SITES = ("round_readback", "done_poll", "prefill_barrier", "device_sync")


def _oracle_value(row, lo, hi):
    """A lockstep row's integer, as the fused round parses it (-1: none)."""
    if not isinstance(row, dict) or "error" in row:
        return -1
    v = row.get("value")
    if isinstance(v, bool) or not isinstance(v, int):
        return -1
    return v if lo <= v <= hi else -1


def phase_p12(params):
    """P12: the fused mega-round at bench-8b, on P1's engine over the
    shared weights, with the host-sync auditor and compile accounting on.

    Engine level (the JAX package's perf-gate oracle arm): three fused
    rounds (10 agents, range 0-50, 20-round template, one Byzantine, all
    to all without self, state carried), each followed by
    ``batch_generate_json`` at temperature 0 over the same template
    prompts with each phase's budget.  Decision and vote mismatches must be
    0, every fused round must make exactly one host sync (the
    ``round_readback`` seam; no ``done_poll``, ``prefill_barrier`` or
    ``device_sync``), and rounds 2-3 must add no compile record.  Prints
    ``megaround P12``.

    Game level: one 8 honest + 2 Byzantine game (seed 0, 3 rounds,
    ``AgentConfig(megaround=True)``) through ``BCGSimulation``; the counts
    set to 0 just before and read just after, B1, B3a and B2 captured.
    Fails if the lockstep fallback is taken (its warning is made an
    error), a round is not fused, a proposal or vote does not parse, or a
    round makes more than one host sync.  Prints ``game P12``; returns the
    game's launch counts and captured inputs."""
    import dataclasses
    import warnings

    import numpy as np
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.obs import counters
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    forms = PATHS["P1"]["kernels"]
    cfg = game_config(P12_ROUNDS, **PATHS["P1"]["engine"])
    cfg = dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, megaround=True))
    lo, hi = cfg.game.value_range
    n = cfg.game.num_honest + cfg.game.num_byzantine
    os.environ.update(P12_FLAGS)
    obs_reset()

    def syncs():
        return {k: counters.value(f"engine.hostsync.{k}") for k in
                ["total"] + [f"site.{s}" for s in P12_SYNC_SITES]}

    try:
        t0 = time.perf_counter()
        engine = TorchEngine(cfg.engine, device=DEVICE, params=params)
        torch.cuda.synchronize()
        boot_s = time.perf_counter() - t0

        # -- engine level: fused rounds against the lockstep oracle
        plan = engine.prepare_megaround(n_agents=n, lo=lo, hi=hi, max_rounds=20)
        mask = ~np.eye(n, dtype=bool)
        byz = np.arange(n) == n - 1
        values = np.random.default_rng(0).integers(lo, hi + 1, n).astype(np.int32)
        initials = values.copy()
        inbox = np.full((n, n), -1, np.int32)
        rounds, mismatched = [], []
        for r in range(1, P12_ROUNDS + 1):
            torch.cuda.synchronize()
            before = syncs()
            compiles = counters.value("engine.compile_obs.cache_entries")
            t0 = time.perf_counter()
            res = engine.run_megaround(plan, values, inbox, r, mask, byz, initials)
            fused_s = time.perf_counter() - t0
            after = syncs()
            new_compiles = counters.value("engine.compile_obs.cache_entries") - compiles
            steps = engine.last_decode_steps
            t0 = time.perf_counter()
            dec = engine.batch_generate_json(plan.template.decision_prompts(values, inbox, r),
                                             temperature=0.0, max_tokens=plan.decide.max_new)
            vote = engine.batch_generate_json(
                plan.template.vote_prompts(res.values, res.received, r),
                temperature=0.0, max_tokens=plan.vote.max_new)
            torch.cuda.synchronize()
            lockstep_s = time.perf_counter() - t0
            want_dec = [_oracle_value(d, lo, hi) for d in dec]
            want_vote = [1 if _oracle_value(v, 0, 1) == 1 else 0 for v in vote]
            for i in range(n):
                for what, got, want in (("decision", res.proposed[i], want_dec[i]),
                                        ("vote", res.votes[i], want_vote[i])):
                    if int(got) != want:
                        mismatched.append({"round": r, "agent": i, "phase": what,
                                           "fused": int(got), "lockstep": want,
                                           "lockstep_row": dec[i] if what == "decision"
                                           else vote[i]})
            rounds.append({
                "round": r, "syncs": {k: after[k] - before[k] for k in after},
                "compile_records": new_compiles, "decode_steps": steps,
                "fused_seconds": fused_s, "lockstep_pair_seconds": lockstep_s,
                "proposed": res.proposed.tolist(), "votes": res.votes.tolist(),
                "terminate": res.terminate, "agreement_pct": res.agreement_pct,
            })
            values, inbox = res.values, res.received
        warm = rounds[1:]
        line = {
            "rounds": rounds, "boot_seconds": boot_s,
            "decision_mismatches": sum(m["phase"] == "decision" for m in mismatched),
            "vote_mismatches": sum(m["phase"] == "vote" for m in mismatched),
            "mismatched": mismatched[:10],
            "syncs_per_round": [x["syncs"]["total"] for x in rounds],
            "compile_records_after_round_1": sum(x["compile_records"] for x in warm),
            "decode_steps_per_round": [x["decode_steps"] for x in rounds],
            "warm_fused_round_seconds": statistics.mean(x["fused_seconds"] for x in warm),
            "warm_lockstep_pair_seconds": statistics.mean(
                x["lockstep_pair_seconds"] for x in warm),
            "windows": {p: [getattr(plan, p).L, getattr(plan, p).prompt_len,
                            getattr(plan, p).prefix_len, getattr(plan, p).max_new]
                        for p in ("decide", "vote")},
        }
        print("megaround P12: " + json.dumps(line), flush=True)
        engine_checks = {
            "0 decision and 0 vote mismatches": not mismatched,
            "one host sync a fused round, at round_readback": all(
                x["syncs"] == {"total": 1, "site.round_readback": 1, "site.done_poll": 0,
                               "site.prefill_barrier": 0, "site.device_sync": 0}
                for x in rounds),
            "no compile record after round 1": line["compile_records_after_round_1"] == 0,
        }

        # -- game level: a fused game through the entry point
        results, game_steps = [], []
        call = engine.run_megaround

        def recorded(*args, **kw):
            results.append(call(*args, **kw))
            game_steps.append(engine.last_decode_steps)
            return results[-1]

        engine.run_megaround = recorded
        fused0 = engine.megaround_rounds
        hs0 = (counters.value("game.host_syncs.count"), counters.value("game.host_syncs.sum"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cap = Capture(forms)
        try:
            zero_counts()
            t0 = time.perf_counter()
            with warnings.catch_warnings():
                warnings.filterwarnings("error", message="megaround requested",
                                        category=RuntimeWarning)
                sim = BCGSimulation(cfg, engine=engine)
                stats, decisions, votes = play_recorded(sim)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            cap.restore()
            engine.run_megaround = call
        peak = torch.cuda.max_memory_allocated()
        game_rounds = counters.value("game.host_syncs.count") - hs0[0]
        game_syncs = counters.value("game.host_syncs.sum") - hs0[1]
        invalid = sum(int((r.proposed < 0).sum() + (r.vote_raw < 0).sum()) for r in results)
        decisions_n = 2 * n * stats["total_rounds"]
        gline = {
            "rounds": stats["total_rounds"], "fused_rounds": engine.megaround_rounds - fused0,
            "termination_reason": stats.get("termination_reason"),
            "decisions_by_round": [d for _, d in decisions],
            "votes_by_round": [v for _, v in votes],
            "statistics_keys": len(stats), "failed_rows": engine.failed_rows,
            "unparsed_proposals_and_votes": invalid, "decisions": decisions_n,
            "game_seconds": wall, "agent_decisions_per_sec": decisions_n / wall,
            "decode_steps_per_round": game_steps,
            "host_syncs_per_round": game_syncs / max(game_rounds, 1),
            "peak_bytes": peak, "launches": {k: counts[k] for k in forms},
            "capture_copied_bytes": cap.copied_bytes,
        }
        print("game P12: " + json.dumps(gline), flush=True)
    finally:
        for name in P12_FLAGS:
            os.environ.pop(name, None)
        obs_reset()
    checks = dict(engine_checks, **{
        "the fused path (no lockstep fallback)": sim._megaround_plan is not None,
        "every round fused": gline["fused_rounds"] == gline["rounds"] == sim._megaround_rounds
        >= 1,
        "statistics well formed": len(stats) > 40,
        "every proposal and vote parsed": invalid == 0 and engine.failed_rows == 0,
        "one host sync a game round": game_rounds == gline["rounds"] and game_syncs == game_rounds,
        "B1, B3a and B2 launched": all(counts[k] > 0 for k in forms),
    })
    bad = [k for k, ok in checks.items() if not ok]
    engine.shutdown()
    del engine, sim
    torch.cuda.empty_cache()
    if bad:
        fail(f"P12: {bad}")
    return counts, cap.inputs()


# The mesh paths, P14 and P15: the depth kept, the logits' limit
# (relative L2 per row against the one-rank engine, teacher-forced: every
# arm is fed its reference's tokens), the sampler calls of each guided
# loop whose logits are held to it (0: the prefill's), the step whose time
# and collectives are printed, and a world's wall limit.  The limit is
# fixed, 2.6 times the one-rank engine's own spread under a change of
# summation order alone: fed its own tokens with B3a's split planned for
# half the kv heads, it moves 0.0112-0.0117 a row at every held decode
# step at 12 layers, 0 at the prefills (``python -m
# bcg_tpu_torch.tools.mesh_floor --depth 12`` on an H100 80GB HBM3 at
# 700 W; PERF.md).  A fault (a wrong head, a lost cache write) moves a row
# by 0.1 or more.
MESH_DEPTH = 4
P14_LOGIT_TOL = 0.03
P14_CHECK_STEPS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256)
P14_TIMED_STEP = 5
MESH_WORLD_LIMIT_S = 480
MESH_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "mesh")
# One world a mesh shape, its arms one after another (a world starts
# once).  P14: the default engine under tp, sp and dp.  P15: every
# other engine the port serves on one device, each arm
# the engine of the one-device path it mirrors.
MESH_WORLDS = {
    "tp": (dict(tensor_parallel_size=2), ("p14-tp", "tp-w8-ff", "tp-w4-paged-spec")),
    "sp": (dict(sequence_parallel_size=2), ("p14-sp", "sp-int8-ff", "sp-spec")),
    "dp": (dict(data_parallel_size=2), ("p14-dp", "dp-paged", "served")),
}
_P1_KERNELS = ("flash_prefill", "decode_attention", "guided_sampler")
# Each arm: its path, engine knobs, the kernels it must launch on every
# rank (under sp the ring and the slices' merge take attention's place),
# the forms rank 0 of the tp world captures in it, and its reference (the
# P14 arms share one: P1's engine at the same depth).
MESH_ARMS = {
    "p14-tp": dict(path="P14", engine={}, kernels=_P1_KERNELS, capture=_P1_KERNELS,
                   reference="p14"),
    "p14-sp": dict(path="P14", engine={}, kernels=("guided_sampler",), reference="p14"),
    "p14-dp": dict(path="P14", engine={}, spmd_exchange=True, kernels=_P1_KERNELS,
                   reference="p14"),
    # P8: int8 weights (W8A8), int8 cache, fast-forward, compact JSON.
    "tp-w8-ff": dict(path="P15", engine=dict(quantization="int8", kv_cache_dtype="int8",
                                             decode_fast_forward=True,
                                             guided_compact_json=True),
                     kernels=("flash_prefill", "chunk_decode_attention_int8", "guided_sampler"),
                     capture=("chunk_decode_attention_int8",)),
    # P9 x P7: int4 weights (W4A16), a paged int8 pool, speculative.
    "tp-w4-paged-spec": dict(path="P15", engine=dict(quantization="int4", paged_kv=True,
                                                     kv_pool_blocks=PAGED_POOL_BLOCKS,
                                                     kv_cache_dtype="int8", spec_decode=True),
                             kernels=("flash_prefill", "paged_chunk_attention_int8",
                                      "guided_sampler", "w4a16_matmul"),
                             capture=("w4a16_matmul", "paged_chunk_attention_int8")),
    # P2: int8 cache, fast-forward, compact JSON.
    "sp-int8-ff": dict(path="P15", engine=dict(kv_cache_dtype="int8", decode_fast_forward=True,
                                               guided_compact_json=True),
                       kernels=("guided_sampler",)),
    # P3: bf16 cache, speculative.
    "sp-spec": dict(path="P15", engine=dict(spec_decode=True), kernels=("guided_sampler",)),
    # P5: a paged bf16 pool, the plain loop; two rounds (the second's
    # prompts extend the first's radix chains).
    "dp-paged": dict(path="P15", engine=dict(paged_kv=True, kv_pool_blocks=PAGED_POOL_BLOCKS),
                     rounds=2, kernels=("flash_prefill", "paged_decode_attention_bf16",
                                        "guided_sampler")),
    # P1's engine behind ServingEngine: two greedy games, default linger.
    "served": dict(path="P15", engine={}, kernels=_P1_KERNELS),
}
P15_SERVED_SEEDS = (0, 1)


def _arm_label(arm: str) -> str:
    """The arm's line name: ``P14 tp`` or ``P15 tp-w8-ff``."""
    conf = MESH_ARMS[arm]
    return f"{conf['path']} {arm[4:] if arm.startswith('p14-') else arm}"


class TeacherForcing:
    """Wraps the engine's ``make_fused_sampler`` (each guided loop's
    sampler), the speculative verify's acceptance (``accept_draft``) and
    each loop's step (``decode_step``, the fast-forward ``decode_chunk``,
    the verify's ``decode_chunk_spec``).  Keeps, per loop, each sampler
    call's tokens, each verify's accepted counts and, at
    ``P14_CHECK_STEPS``, the sampler's logits (on the host), and the
    ``engine.collective.*`` counts and time of the ``P14_TIMED_STEP``-th
    step.  Given ``forced`` (another run's :meth:`record`, or its
    ``tokens`` alone), every sampler call still samples the logits it is
    given (B2 launches as it would), then returns the forced tokens (rows
    ``dp_rank`` of ``dp``) and the grammar states they lead to, and every
    verify takes the forced accepted counts; ``flips`` counts the live
    rows whose own greedy token (or accepted count) differed."""

    def __init__(self, forced=None, dp_rank=0):
        from bcg_tpu_torch.engine import speculative, torch_engine as te
        from bcg_tpu_torch.models import transformer

        if isinstance(forced, dict):
            self.forced, self.forced_acc = forced["tokens"], forced["accepts"]
        else:
            self.forced, self.forced_acc = forced, None
        self.dp_rank = dp_rank
        self.tokens, self.accepts, self.logits = [], [], []
        self.flips = 0
        self.steps = 0
        self.collectives, self.step_ms = {}, None
        self._mods = (te, speculative, transformer)
        self._orig = (te.make_fused_sampler, te.decode_step, te.decode_chunk,
                      speculative.accept_draft, transformer.decode_chunk_spec)
        te.make_fused_sampler = self._make_sampler
        te.decode_step = self._timed(self._orig[1])
        te.decode_chunk = self._timed(self._orig[2])
        speculative.accept_draft = self._accept
        transformer.decode_chunk_spec = self._timed(self._orig[4])

    def restore(self):
        te, speculative, transformer = self._mods
        (te.make_fused_sampler, te.decode_step, te.decode_chunk, speculative.accept_draft,
         transformer.decode_chunk_spec) = self._orig
        self.tokens = [[t.cpu() for t in loop] for loop in self.tokens]
        self.accepts = [[a.cpu() for a in loop] for loop in self.accepts]
        self.flips = int(self.flips)

    def record(self):
        """What another run is forced with (after :meth:`restore`)."""
        return {"tokens": self.tokens, "accepts": self.accepts}

    def _rows(self, t, n):
        return t[self.dp_rank * n:(self.dp_rank + 1) * n]

    def _make_sampler(self, eos_id, top_p):
        import torch

        real = self._orig[0](eos_id, top_p)
        loop = len(self.tokens)
        self.tokens.append([])
        self.accepts.append([])
        self.logits.append({})

        def sample(logits, states, generator, emitted, tables, accepting, min_budget,
                   dfa_ids, row_temp, row_budget, **kw):
            tok, nxt = real(logits, states, generator, emitted, tables, accepting,
                            min_budget, dfa_ids, row_temp, row_budget, **kw)
            step = len(self.tokens[loop])
            if step in P14_CHECK_STEPS:
                self.logits[loop][step] = logits.float().cpu()
            if self.forced is not None:
                want = self._rows(self.forced[loop][step], tok.shape[0]).to(tok.device)
                self.flips = self.flips + ((tok != want) & (states >= 0)).sum()
                # The sampler's own rule for the next grammar state.
                nxt = tables[dfa_ids.long(), states.clamp(min=0).long(),
                             want.long().clamp(max=logits.shape[1] - 1)]
                nxt = torch.where(want == eos_id, torch.full_like(want, -1), nxt.to(torch.int32))
                tok = want
            self.tokens[loop].append(tok)
            return tok, nxt

        return sample

    def _accept(self, logits_all, draft, draft_mask, *args, **kwargs):
        import torch

        acc, forbid, nxt = self._orig[3](logits_all, draft, draft_mask, *args, **kwargs)
        loop = len(self.accepts) - 1
        if self.forced_acc is not None:
            B, K1, V = logits_all.shape
            want = self._rows(self.forced_acc[loop][len(self.accepts[loop])], B)
            want = want.to(acc.device)
            self.flips = self.flips + (acc != want).sum()
            acc = want
            rejected = torch.gather(draft, 1, acc.clamp(0, K1 - 2)[:, None].long())[:, 0]
            forbid = torch.where(acc < draft_mask.sum(dim=1), rejected,
                                 torch.full_like(rejected, -1))
            nxt = torch.gather(logits_all, 1, acc[:, None, None].long().expand(B, 1, V))[:, 0]
        self.accepts[loop].append(acc)
        return acc, forbid, nxt

    def _timed(self, step_fn):
        def step(*args, **kwargs):
            import torch

            from bcg_tpu_torch.obs import counters

            self.steps += 1
            if self.steps != P14_TIMED_STEP:
                return step_fn(*args, **kwargs)
            before = counters.snapshot()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step_fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.step_ms = (time.perf_counter() - t0) * 1e3
            self.collectives = {k.split(".", 2)[2]: v - before.get(k, 0)
                                for k, v in counters.snapshot().items()
                                if k.startswith("engine.collective.")
                                and v - before.get(k, 0)}
            return out

        return step


def _rel_rows(got, want) -> float:
    """The largest relative L2 distance of a row of ``got`` from ``want``'s."""
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


def _game_changes(game, ref):
    """The decisions and votes of ``game`` that differ from ``ref``'s."""
    out = {}
    for kind in ("decisions", "votes"):
        n = 0
        for (_, got), (_, want) in zip(game[kind], ref[kind]):
            n += sum(got.get(a) != v for a, v in want.items())
        out[kind] = n
    return out


class _RankMesh:
    """What the port's slicing (``parallel.sharding.shard_leaf``) reads of
    a mesh: the axes' sizes and one rank's coordinates."""

    def __init__(self, dp=1, tp=1, sp=1, rank=(0, 0, 0)):
        import numpy as np

        self.mesh_dim_names = ("dp", "tp", "sp")
        self.mesh = np.zeros((dp, tp, sp))
        self._rank = dict(zip(self.mesh_dim_names, rank))

    def get_local_rank(self, axis):
        return self._rank[axis]

    def size(self):
        return self.mesh.size


def mesh_config(arm, seed=0, mesh=True):
    """The arm's game config: its rounds (one, greedy), its engine knobs
    and (``mesh``) its world's sizes."""
    import dataclasses

    from bcg_tpu_torch.config import NetworkConfig

    conf = MESH_ARMS[arm]
    sizes = next(sz for sz, arms in MESH_WORLDS.values() if arm in arms) if mesh else {}
    cfg = game_config(conf.get("rounds", 1), greedy=True, **conf["engine"], **sizes)
    cfg = dataclasses.replace(cfg, game=dataclasses.replace(cfg.game, seed=seed))
    if mesh and conf.get("spmd_exchange"):
        cfg = dataclasses.replace(cfg, network=NetworkConfig(spmd_exchange=True))
    return cfg


def mesh_weights(arm, mesh, dev):
    """A rank's weights for ``arm``: bench-8b from seed 0 through
    ``loader.init_random_params_sharded`` (its slices only), quantized
    leaf by leaf by the sharded quantizer where the arm quantizes (each
    full leaf quantized, then sliced), cut to ``MESH_DEPTH`` layers."""
    import torch

    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import init_random_params_sharded
    from bcg_tpu_torch.models.quantize import ensure_quantized_head, quantize_leaf_transform

    spec = spec_for_model(MODEL)
    mode = MESH_ARMS[arm]["engine"].get("quantization")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    full = init_random_params_sharded(
        spec, gen, mesh, dev,
        leaf_transform=quantize_leaf_transform(spec, mode, mesh=mesh) if mode else None)
    if mode:
        ensure_quantized_head(full, spec, mode)
    cut_spec, params = cut_depth(full, MESH_DEPTH)
    del full
    torch.cuda.empty_cache()   # the dropped layers go back to the card the ranks share
    return cut_spec, params


def mesh_rank(world, out, forced):
    """One rank of a mesh world (``parallel.distributed.spawn_world``):
    the world's arms one after another, each on its engine over its
    weights (the bf16 arms share one draw), fed its reference's tokens and
    accepted counts (``forced``: a directory of ``TeacherForcing.record``
    files), its results under ``out``.  The ``served`` arm plays two games
    behind ``ServingEngine`` on rank 0 while rank 1 follows.  Rank 0 of
    the tp world captures each arm's ``capture`` forms, by path."""
    import torch
    import torch.distributed as dist

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.parallel import distributed
    from bcg_tpu_torch.parallel.mesh import mesh_from_engine_config
    from bcg_tpu_torch.parallel.sharding import tree_bytes_per_device
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation
    from bcg_tpu_torch.tools import coop_probe

    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = distributed.device()
    captures, counts = {}, {}
    shared = None
    for arm in MESH_WORLDS[world][1]:
        conf = MESH_ARMS[arm]
        t0 = time.perf_counter()
        cfg = mesh_config(arm)
        mesh = mesh_from_engine_config(cfg.engine)
        quantized = "quantization" in conf["engine"]
        if quantized or shared is None:
            shared = None
            torch.cuda.empty_cache()
            spec, params = mesh_weights(arm, mesh, dev)
            if not quantized:
                shared = (spec, params)
        else:
            spec, params = shared
        sums = coop_probe.part_checksums(params)
        engine = TorchEngine(cfg.engine, device=dev, params=params, spec=spec, mesh=mesh)
        del params
        weight_bytes = tree_bytes_per_device(engine.params)
        dp_rank = engine.spec.par.dp_rank
        forced_rec = (None if arm == "served" else
                      torch.load(os.path.join(forced, f"{conf.get('reference', arm)}.pt")))
        cap = (Capture(conf["capture"]) if world == "tp" and rank == 0 and conf.get("capture")
               else None)
        rec = TeacherForcing(forced_rec, dp_rank=dp_rank)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        line = {}
        try:
            if arm == "served":
                line = mesh_serve(engine, rank)
            else:
                stats, decisions, votes = play_recorded(BCGSimulation(cfg, engine=engine))
                line["game"] = json.loads(json.dumps(
                    dict(stats=stats, decisions=decisions, votes=votes), sort_keys=True,
                    default=str))
            torch.cuda.synchronize()
        finally:
            rec.restore()
            if cap is not None:
                cap.restore()
        launches = launch_counts()
        path = conf["path"]
        counts[path] = {k: counts.get(path, {}).get(k, 0) + v for k, v in launches.items()}
        if cap is not None:
            captures.setdefault(path, {}).update(move_inputs({path: cap.inputs()}, "cpu")[path])
            del cap
        pool = engine.kv_pool_stats()
        line.update(
            rank=rank, arm=arm, failed_rows=engine.failed_rows,
            total_rows=engine.total_rows, decode_steps=engine.total_decode_steps,
            peak_bytes=torch.cuda.max_memory_allocated(), weight_bytes=weight_bytes,
            launches={k: v for k, v in launches.items() if v}, counts=launches,
            step_collectives=rec.collectives, step_ms=rec.step_ms, flips=rec.flips,
            sampler_calls=[len(loop) for loop in rec.tokens],
            sp_bypasses=engine.sp_bypasses, dp_bypasses=engine.dp_bypasses,
            dp_rank=dp_rank, checksums=sums,
            pool=None if pool is None else {k: pool[k] for k in (
                "blocks_total", "blocks_free", "blocks_resident", "prefix_hit_rate")},
            spec_drafted=engine.spec_drafted, spec_accepted=engine.spec_accepted,
            wall_seconds=time.perf_counter() - t0)
        if pool is not None:
            line["pool_digest"] = pool_digest(engine)
        with open(os.path.join(out, f"{arm}.rank{rank}.json"), "w") as f:
            json.dump(line, f)
        torch.save({"logits": rec.logits, **rec.record()},
                   os.path.join(out, f"{arm}.rank{rank}.pt"))
        engine.shutdown()
        del engine
        torch.cuda.empty_cache()
    if world == "tp" and rank == 0:
        for path, got in captures.items():
            torch.save(got, os.path.join(out, f"captured_{path}.pt"))
        with open(os.path.join(out, "counts.json"), "w") as f:
            json.dump(counts, f)


def pool_digest(engine) -> str:
    """A digest of the paged pool's contents (every layer's blocks): the
    dp ranks' pools must be equal."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for entry in engine._paged.pool:
        for name in sorted(entry):
            h.update(entry[name].contiguous().view(-1).view(torch.uint8).cpu().numpy()
                     .tobytes())
    return h.hexdigest()


def mesh_serve(engine, rank):
    """The served arm on one rank: rank 0 plays ``P15_SERVED_SEEDS``'s
    games through ``run_serving_simulations`` over ``ServingEngine`` (the
    leader records every dispatch); rank 1 follows.  Returns the rank's
    line: the games, the dispatches and their outputs."""
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation
    from bcg_tpu_torch.serve import ServingEngine, mesh as mesh_serving, run_serving_simulations

    if rank != 0:
        outs = mesh_serving.follow(engine, record=True)
        return dict(outputs=json.loads(json.dumps(outs, default=str)))

    def game(seed):
        def run(served):
            sim = BCGSimulation(mesh_config("served", seed=seed), engine=served)
            stats, decisions, votes = play_recorded(sim)
            return json.loads(json.dumps(dict(stats=stats, decisions=decisions, votes=votes),
                                         sort_keys=True, default=str))
        return run

    serving = ServingEngine(engine)
    serving.leader.record = True
    games = run_serving_simulations(engine, [game(s) for s in P15_SERVED_SEEDS],
                                    serving=serving)
    stats = serving.stats()
    serving.shutdown()
    for g in games:
        if isinstance(g, BaseException):
            raise g
    log = serving.leader.log
    return dict(games=games, dispatches=[dict(index=d["index"], method=d["method"],
                                              args=d["args"], kwargs=d["kwargs"]) for d in log],
                outputs=json.loads(json.dumps([d["out"] for d in log], default=str)),
                rows_per_dispatch=[len(d["args"][0]) for d in log],
                merged_dispatches=stats["merged_dispatches"], dispatches_n=stats["dispatches"],
                row_cap=stats.get("row_cap"))


def mesh_reference(arm, params):
    """The parent's one-rank engine of the arm's config over the shared
    weights cut to ``MESH_DEPTH``: one greedy round, its tokens, accepted
    counts and held logits recorded."""
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine
    from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

    spec, ref_params = cut_depth(params, MESH_DEPTH)
    cfg = mesh_config(arm, mesh=False)
    engine = TorchEngine(cfg.engine, device=DEVICE, params=ref_params, spec=spec)
    rec = TeacherForcing()
    t0 = time.perf_counter()
    try:
        stats, decisions, votes = play_recorded(BCGSimulation(cfg, engine=engine))
    finally:
        rec.restore()
    game = json.loads(json.dumps(dict(stats=stats, decisions=decisions, votes=votes),
                                 sort_keys=True, default=str))
    if engine.failed_rows:
        fail(f"{_arm_label(arm)} reference: {engine.failed_rows} rows failed")
    info = dict(layers=MESH_DEPTH, failed_rows=engine.failed_rows,
                decode_steps=engine.total_decode_steps,
                sampler_calls=[len(loop) for loop in rec.tokens],
                game_seconds=time.perf_counter() - t0, step_ms=rec.step_ms,
                logit_tol=P14_LOGIT_TOL)
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    return game, rec, info


def mesh_slices(arm, params, spec, tp):
    """Each rank's expected leaf checksums: the slices of the shared
    weights (quantized whole first where the arm quantizes)."""
    import torch

    from bcg_tpu_torch.models.quantize import weight_quantizer
    from bcg_tpu_torch.parallel.sharding import shard_params
    from bcg_tpu_torch.tools import coop_probe

    mode = MESH_ARMS[arm]["engine"].get("quantization")
    _, cut = cut_depth(params, MESH_DEPTH)
    out = []
    for r in range(tp):
        mine = shard_params(cut, spec, _RankMesh(tp=tp, rank=(0, r, 0)),
                            quantize=weight_quantizer(mode) if mode else None)
        out.append(coop_probe.part_checksums(mine))
        del mine
        torch.cuda.empty_cache()
    return out


def mesh_logits(ranks, arm_dir, arm, ref_logits):
    """The largest relative L2 a row of every held logits against the
    reference's, by loop.step, and whether each loop's prefill and first
    step were held."""
    import torch

    worst, by_step, held = 0.0, {}, True
    for r, res in enumerate(ranks):
        got = torch.load(os.path.join(arm_dir, f"{arm}.rank{r}.pt"))["logits"]
        for loop, steps in enumerate(got):
            for step, logits in steps.items():
                n = logits.shape[0]
                want = ref_logits[loop][step][res["dp_rank"] * n:(res["dp_rank"] + 1) * n]
                rel = _rel_rows(logits[:want.shape[0]], want)
                key = f"{loop}.{step}"
                by_step[key] = max(by_step.get(key, 0.0), rel)
                worst = max(worst, rel)
        held = held and bool(got) and all(0 in steps and 1 in steps for steps in got)
    return worst, by_step, held


def mesh_replay(params, ranks, arm_dir):
    """The served arm held the other way round: rank 0's dispatches
    replayed in order through the parent's one-rank engine, fed the arm's
    tokens (both dp ranks' rows), its logits kept for the arm's."""
    import torch

    from bcg_tpu_torch.engine.torch_engine import TorchEngine

    spec, ref_params = cut_depth(params, MESH_DEPTH)
    engine = TorchEngine(mesh_config("served", mesh=False).engine, device=DEVICE,
                         params=ref_params, spec=spec)
    recs = [torch.load(os.path.join(arm_dir, f"served.rank{r}.pt")) for r in range(len(ranks))]
    order = sorted(range(len(ranks)), key=lambda r: ranks[r]["dp_rank"])
    tokens = [[torch.cat([recs[r]["tokens"][loop][step] for r in order])
               for step in range(len(recs[0]["tokens"][loop]))]
              for loop in range(len(recs[0]["tokens"]))]
    rec = TeacherForcing({"tokens": tokens, "accepts": None})
    outputs = []
    try:
        for d in ranks[0]["dispatches"]:
            args = [[tuple(p) if isinstance(p, list) else p for p in d["args"][0]],
                    *d["args"][1:]]
            outputs.append(getattr(engine, d["method"])(*args, **d["kwargs"]))
    finally:
        rec.restore()
    failed = engine.failed_rows
    engine.shutdown()
    del engine
    torch.cuda.empty_cache()
    return rec, json.loads(json.dumps(outputs, default=str)), failed


def mesh_check(arm, ranks, out, ref, params, spec, tp, sizes):
    """The arm's ranks held to ``ref`` (``(game, TeacherForcing)``; the
    served arm: its replay): the weights, the games, the held logits,
    the launches, the pools.  Returns the printed line and the errors."""
    from bcg_tpu_torch.tools import coop_probe

    conf = MESH_ARMS[arm]
    errors = []
    want_sums = (mesh_slices(arm, params, spec, tp) if tp > 1
                 else [coop_probe.part_checksums(cut_depth(params, MESH_DEPTH)[1])])
    for r, res in enumerate(ranks):
        want = want_sums[r if tp > 1 else 0]
        bad = sorted(n for n in want if want[n] != res["checksums"].get(n))
        if bad or set(res["checksums"]) != set(want):
            errors.append(f"rank {r}: {len(bad)} leaf parts differ from the shared "
                          f"weights' slices (first {bad[:3]})")
        if res["failed_rows"]:
            errors.append(f"rank {r}: {res['failed_rows']} failed rows")
        for name in conf["kernels"]:
            if res["launches"].get(name, 0) <= 0:
                errors.append(f"rank {r}: kernel {name} was never launched")
    extra = {}
    if arm == "served":
        rec, replay_out, replay_failed = mesh_replay(params, ranks, out)
        if ranks[0]["outputs"] != ranks[1]["outputs"]:
            errors.append("the ranks' gathered outputs differ")
        if replay_out != ranks[0]["outputs"]:
            errors.append("the one-rank replay's outputs differ from the arm's")
        if replay_failed:
            errors.append(f"the replay failed {replay_failed} rows")
        split = [n for n in ranks[0]["rows_per_dispatch"] if n >= 2]
        if ranks[0]["merged_dispatches"] < 1 or not split or ranks[0]["dp_bypasses"]:
            errors.append("no dispatch merged both games' rows split over the ranks")
        extra = dict(dispatches=ranks[0]["dispatches_n"],
                     merged_dispatches=ranks[0]["merged_dispatches"],
                     rows_per_dispatch=ranks[0]["rows_per_dispatch"],
                     row_cap=ranks[0]["row_cap"], replay_flips=rec.flips,
                     games=[{k: g["stats"].get(k) for k in ("total_rounds",
                                                           "termination_reason")}
                            for g in ranks[0]["games"]])
    else:
        ref_game, rec = ref
        for r, res in enumerate(ranks):
            if res["game"] != ref_game:
                errors.append(f"rank {r}: the game differs from the reference's "
                              f"({_game_changes(res['game'], ref_game)})")
        extra["game_equal"] = all(res["game"] == ref_game for res in ranks)
    worst, by_step, held = mesh_logits(ranks, out, arm, rec.logits)
    if not held:
        errors.append("a loop's prefill or first decode step was not held")
    if worst > P14_LOGIT_TOL:
        errors.append(f"logits: relative L2 {worst:.4g} a row (limit {P14_LOGIT_TOL}; "
                      f"by loop.step: {by_step})")
    if ranks[0].get("pool_digest") is not None and sizes.get("data_parallel_size"):
        if ranks[0]["pool_digest"] != ranks[1]["pool_digest"]:
            errors.append("the dp ranks' paged pools differ")
        extra["pools_equal"] = ranks[0]["pool_digest"] == ranks[1]["pool_digest"]
    line = dict(
        mesh={"dp": sizes.get("data_parallel_size", 1), "tp": tp,
              "sp": sizes.get("sequence_parallel_size", 1)},
        layers=MESH_DEPTH, engine=conf["engine"],
        failed_rows=sum(res["failed_rows"] for res in ranks),
        rel_l2=worst, rel_l2_by_step=by_step, logit_tol=P14_LOGIT_TOL,
        flips_per_rank=[res["flips"] for res in ranks],
        sampler_calls_per_rank=[res["sampler_calls"] for res in ranks],
        launches_per_rank=[res["launches"] for res in ranks],
        step_collectives=ranks[0]["step_collectives"], step_ms=ranks[0]["step_ms"],
        decode_steps=[res["decode_steps"] for res in ranks],
        peak_bytes_per_rank=[res["peak_bytes"] for res in ranks],
        weight_bytes_per_rank=[res["weight_bytes"] for res in ranks],
        pool=ranks[0]["pool"],
        spec_drafted_accepted=[ranks[0]["spec_drafted"], ranks[0]["spec_accepted"]],
        sp_bypasses=ranks[0]["sp_bypasses"], dp_bypasses=ranks[0]["dp_bypasses"],
        wall_seconds=max(res["wall_seconds"] for res in ranks), **extra)
    return line, errors


def phase_mesh(params):
    """P14 and P15 (see the module docstring): per world, the references
    of its arms, then the world of two ranks, each arm held to its
    reference.  Returns, by path, rank 0 of the tp world's launch counts
    and its captured kernel inputs."""
    import shutil

    import torch

    from bcg_tpu_torch.parallel import distributed

    root = os.path.dirname(os.path.abspath(__file__))
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    os.makedirs(MESH_DIR)
    forced = os.path.join(MESH_DIR, "forced")
    os.makedirs(forced)
    spec, _ = cut_depth(params, MESH_DEPTH)
    refs, by_path = {}, {}
    for world, (sizes, arms) in MESH_WORLDS.items():
        for arm in arms:
            key = MESH_ARMS[arm].get("reference", arm)
            if arm == "served" or key in refs:
                continue
            game, rec, info = mesh_reference(arm, params)
            refs[key] = (game, rec)
            torch.save(rec.record(), os.path.join(forced, f"{key}.pt"))
            label = "P14" if key == "p14" else _arm_label(arm)
            print(f"game {label} reference: " + json.dumps(info), flush=True)
        out = os.path.join(MESH_DIR, world)
        os.makedirs(out)
        t0 = time.perf_counter()
        try:
            distributed.spawn_world("chip_smoke:mesh_rank", 2, timeout_s=MESH_WORLD_LIMIT_S,
                                    args=dict(world=world, out=out, forced=forced),
                                    sys_path=[root], device_ids=[0, 0])
        except distributed.WorldFailed as exc:
            fail(f"mesh world {world}: {exc}")
        world_wall = time.perf_counter() - t0
        tp = sizes.get("tensor_parallel_size", 1)
        for arm in arms:
            ranks = []
            for r in range(2):
                with open(os.path.join(out, f"{arm}.rank{r}.json")) as f:
                    ranks.append(json.load(f))
            ref = refs.get(MESH_ARMS[arm].get("reference", arm))
            line, errors = mesh_check(arm, ranks, out, ref, params, spec, tp, sizes)
            line["world_seconds"] = world_wall
            print(f"game {_arm_label(arm)}: " + json.dumps(line), flush=True)
            if errors:
                fail(f"{_arm_label(arm)}: " + "; ".join(errors))
        if world == "tp":
            with open(os.path.join(out, "counts.json")) as f:
                counts = json.load(f)
            for path in ("P14", "P15"):
                got = torch.load(os.path.join(out, f"captured_{path}.pt"))
                by_path[path] = (counts[path], {name: tuple(keep(a, DEVICE) for a in args)
                                                for name, args in got.items()})
    return by_path


# P16: the cooperative scale sweep (the sweep's single-job mode over a
# world of ranks) through its own entry point: bench-8b at full width and
# depth, 8 honest + 2 Byzantine agents, dp 2 (two ranks on cuda:0 over
# gloo, 5 agents' rows a rank), the SPMD exchange on, one round.
P16_ARGS = ["--device", "cuda", "--ranks", "2", "--agents", "10", "--rounds", "1",
            "--seed", "0", "--model", MODEL, "--max-model-len", "0", "--decide-tokens", "0",
            "--vote-tokens", "0"]
P16_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "p16")
P16_LIMIT_S = 600
# The JAX script's key set (scripts/scale_sweep.py's JSON line).
P16_KEYS = {"agents", "devices", "dp", "model", "rounds", "rounds_per_sec",
            "decisions_per_sec", "dp_batches", "dp_bypasses", "sp_bypasses", "spmd_mesh_dp",
            "consensus"}
# The measured boot peak may exceed loader.boot_peak_report's by this much.
BOOT_PEAK_SLACK = 1.02


def p16_probe(run, out_dir):
    """A P16 rank's hook (``tools/scale_sweep``): the kernels' counts set to
    0 before the rank's sweep and read after it, around the cooperative
    probe (``tools/coop_probe.probe``); writes ``p16-r<rank>.json``."""
    import torch

    from bcg_tpu_torch.obs import fleet
    from bcg_tpu_torch.tools import coop_probe

    zero_counts()
    summary = coop_probe.probe(run, out_dir)
    torch.cuda.synchronize()
    with open(os.path.join(out_dir, f"p16-r{fleet.process_index()}.json"), "w") as f:
        json.dump(dict(launches=launch_counts(), peak_bytes=torch.cuda.max_memory_allocated()),
                  f)
    return summary


def phase_p16():
    """P16 (see the module docstring): the cooperative scale sweep over a
    two-rank dp world, held to the JAX script's key set, one game on both
    ranks (digests, engine calls, weights), one record, the dense exchange
    and the boot-peak report."""
    import glob
    import shutil

    from bcg_tpu_torch.models.configs import spec_for_model
    from bcg_tpu_torch.models.loader import boot_peak_report
    from bcg_tpu_torch.tools import coop_probe, scale_sweep
    from bcg_tpu_torch.tools.boot_smoke import ShapeMesh

    shutil.rmtree(P16_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    try:
        row = scale_sweep.run(P16_ARGS + ["--sweep-dir", P16_DIR], hook="chip_smoke:p16_probe",
                              limit_s=P16_LIMIT_S)
    except RuntimeError as exc:   # a failed job, or the world's WorldFailed
        fail(f"P16: {exc}")
    wall = time.perf_counter() - t0
    errors = []
    if set(row) != P16_KEYS:
        errors.append(f"key set {sorted(row)}")
    if (row["devices"], row["dp"], row["spmd_mesh_dp"], row["rounds"]) != (2, 2, 2, 1):
        errors.append(f"layout {row}")
    if not (row["dp_batches"] >= 1 and row["rounds_per_sec"] > 0
            and row["decisions_per_sec"] > 0):
        errors.append(f"rates {row}")
    probes = coop_probe.read_probes(P16_DIR)
    ranks = []
    for r in range(2):
        with open(os.path.join(P16_DIR, f"p16-r{r}.json")) as f:
            ranks.append(json.load(f))
    if [p["rank"] for p in probes] != [0, 1]:
        errors.append(f"probes of ranks {[p['rank'] for p in probes]}")
    else:
        for p, extra in zip(probes, ranks):
            if p["failed_rows"] or not p["rows"]:
                errors.append(f"rank {p['rank']}: {p['failed_rows']} of {p['rows']} rows failed")
            for k in _P1_KERNELS:
                if not extra["launches"][k]:
                    errors.append(f"rank {p['rank']}: {k} never launched")
        if probes[0]["game_digest"] != probes[1]["game_digest"]:
            errors.append("the ranks' games differ")
        if probes[0]["dispatches"] != probes[1]["dispatches"]:
            errors.append("the ranks' engine calls differ")
        if probes[0]["weights"]["checksum"] != probes[1]["weights"]["checksum"]:
            errors.append("the ranks' weights differ")
    manifests = glob.glob(os.path.join(P16_DIR, "sweep-manifest-r*.jsonl"))
    records = []
    if manifests != [os.path.join(P16_DIR, "sweep-manifest-r0.jsonl")]:
        errors.append(f"manifests {manifests}")
    else:
        with open(manifests[0]) as f:
            records = [json.loads(line) for line in f]
    header = next((r for r in records if r["event"] == "manifest"), {})
    if not (header.get("process_count") == 2 and header.get("cooperative") is True
            and all(k in header for k in ("run_id", "host", "process_index"))):
        errors.append(f"manifest header {header}")
    ends = [r for r in records if r["event"] == "job_end"]
    if len(ends) != 1 or ends[0].get("status") != "completed":
        errors.append(f"job_end records {ends}")
    events = glob.glob(os.path.join(P16_DIR, "events-*.jsonl"))
    game_ends = sum(1 for path in events for line in open(path)
                    if json.loads(line).get("event") == "game_end")
    if game_ends != 1:
        errors.append(f"{game_ends} game_end records in {events}")
    exchange = (0, 0, 0)
    if len(events) == 1 and probes and probes[0]["game"]:
        exchange = coop_probe.exchange_mismatches(events[0], probes[0]["game"]["decisions"])
    if exchange[0] < 1 or exchange[1] != 10 * exchange[0] or exchange[2]:
        errors.append(f"exchange (rounds, receivers, mismatches) {exchange}")
    # The world's mesh by its shape (what the report reads).
    report = boot_peak_report(spec_for_model(MODEL), ShapeMesh(dp=2), None)
    boots = [p["boot"] for p in probes]
    for p, boot in zip(probes, boots):
        if boot is None or boot["predicted_bytes"] != report["peak_bytes_per_device"]:
            errors.append(f"rank {p['rank']}: boot record {boot}")
        elif boot["peak_bytes"] > boot["predicted_bytes"] * BOOT_PEAK_SLACK:
            errors.append(f"rank {p['rank']}: boot peak {boot['peak_bytes']} past "
                          f"{BOOT_PEAK_SLACK} x the report's {boot['predicted_bytes']}")
    gb = 1e-9
    line = dict(
        rounds=row["rounds"], decisions_per_sec=row["decisions_per_sec"],
        rounds_per_sec=row["rounds_per_sec"], sweep_wall_seconds=ends[0].get("wall_s") if ends
        else None, p16_wall_seconds=wall, consensus=row["consensus"],
        dp_batches=row["dp_batches"], dp_bypasses=row["dp_bypasses"],
        rows=[p["rows"] for p in probes], failed_rows=[p["failed_rows"] for p in probes],
        launches=[{k: r["launches"][k] for k in _P1_KERNELS} for r in ranks],
        collectives=[p["collectives"] for p in probes],
        engine_calls=len(probes[0]["dispatches"]) if probes else None,
        exchange_rounds_receivers_mismatches=list(exchange),
        peak_gb=[r["peak_bytes"] * gb for r in ranks],
        weight_gb=[p["weights"]["bytes"] * gb for p in probes],
        games_equal=bool(probes) and probes[0]["game_digest"] == probes[-1]["game_digest"],
        layers=spec_for_model(MODEL).num_layers)
    print("game P16: " + json.dumps(line), flush=True)
    print("boot P16: " + json.dumps(dict(
        measured_gb=[b and b["peak_bytes"] * gb for b in boots],
        predicted_gb=report["peak_bytes_per_device"] * gb,
        final_tree_gb=report["final_bytes_per_device"] * gb,
        ratio=[b and b["peak_bytes"] / b["predicted_bytes"] for b in boots])), flush=True)
    if errors:
        fail("P16: " + "; ".join(errors))




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


def int4pack_weight(q4, gscale):
    """The port's int4 weight (``q4`` [D/2, F]: element j in the low
    nibble of row j, element j + D/2 in the high one; bf16 ``gscale``
    [D/g, F]) in the layout of ``torch._weight_int4pack_mm``, PyTorch's
    own W4A16 product (B5's library yardstick, never used by the port):
    the unsigned nibbles (value + 8) of the transposed weight [F, D],
    two a byte with the even element in the high nibble, through
    ``torch._convert_weight_to_int4pack``; and [D/g, F, 2] bf16 scales
    with zero points 0, so that its (u - 8) * scale is the port's
    dequantized weight."""
    import torch

    from bcg_tpu_torch.ops.w4_matmul import unpack_int4

    u = (unpack_int4(q4).to(torch.int32) + 8).t().contiguous()               # [F, D]
    w = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 2)
    sz = torch.stack([gscale, torch.zeros_like(gscale)], dim=-1).contiguous()
    return w, sz


def w4_rel(out, ref):
    """Relative L2 error per output row, the largest."""
    return ((out.float() - ref).pow(2).sum(-1).sqrt()
            / ref.pow(2).sum(-1).sqrt().clamp_min(1e-30)).max().item()


def split_check(check, out, split_ref, head_dims):
    """Adds to an attention check the errors against the plain version
    of the split arithmetic at the kernel's plan, held to the same
    limits."""
    row, head = rel_errors(out, split_ref, head_dims)
    check["split_rel_row"], check["split_rel_head"] = row, head
    check["ok"] = check["ok"] and row <= ATTN_REL_ROW_TOL and head <= ATTN_REL_HEAD_TOL


def w4_line(x, q4, gscale):
    """B5 against its plain version at one input: relative L2 error per
    output row, the kernel's, the plain version's and the bound's
    times; beside them ``torch._weight_int4pack_mm`` over the same int4
    weight (the library call of B5's function, its error against the
    plain version printed; its weight converted once, outside the
    timing) and ``torch.matmul`` of x with the weight ALREADY dequantized
    to bf16 (another function: the bf16 product int4 has to beat)."""
    import torch

    from bcg_tpu_torch.models.quantize import dequantize_int4
    from bcg_tpu_torch.ops import w4_matmul as w4

    out = w4.w4a16_matmul_cuda(x, q4, gscale)
    torch.cuda.synchronize()
    ref = w4.w4a16_matmul_plain(x, q4, gscale)
    rel = w4_rel(out, ref)
    err = (out - ref).abs().max().item()
    ok = rel <= W4_REL_ROW_TOL and bool(torch.isfinite(out).all())
    del out
    # Enough weight copies that a graph of calls reads more than twice the
    # L2 (the LM head alone is 311 MB).
    copies = max(1, min(64, -(-100_000_000 // q4.numel())))
    reps = max(20, copies)
    ws = [(q4, gscale)] + [(q4.clone(), gscale.clone()) for _ in range(copies - 1)]
    ms = graph_ms([lambda q=q, g=g: w4.w4a16_matmul_cuda(x, q, g) for q, g in ws], reps)
    plain_ms = time_ms(lambda: w4.w4a16_matmul_plain(x, q4, gscale), reps=5)
    xb = x.to(torch.bfloat16)
    group = 2 * q4.shape[0] // gscale.shape[0]
    lib_ms = lib_rel = lib_error = None
    try:
        packs = [int4pack_weight(q, g) for q, g in ws]
        lib_rel = w4_rel(torch._weight_int4pack_mm(xb, packs[0][0], group, packs[0][1]), ref)
        lib_ms = graph_ms([lambda w=w, sz=sz: torch._weight_int4pack_mm(xb, w, group, sz)
                           for w, sz in packs], reps)
        del packs
    except RuntimeError as exc:   # this torch build refuses the shape: recorded, not timed
        lib_error = str(exc).strip().splitlines()[0][:300]
    del ref
    w_bfs = [dequantize_int4({"q4": q, "gscale": g}) for q, g in ws]
    deq_ms = graph_ms([lambda w=w: torch.matmul(xb, w) for w in w_bfs], reps)
    del ws, w_bfs
    (M, D), F = x.shape, q4.shape[1]
    # q4, gscale and x read once, the f32 output written once.
    byts = q4.numel() + 2 * gscale.numel() + 2 * x.numel() + 4 * M * F
    bms, by = bound(byts, 2 * M * D * F)
    return dict(max_abs_err=err, rel_row=rel, ok=ok, ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms, library_rel_row=lib_rel,
                library_error=lib_error, dequantized_bf16_matmul_ms=deq_ms,
                shape=[M, D, F], group=group)


ROUTE_ROWS = (16, 32, 64, 128, 256)


def w4_route(x, q4, gscale):
    """Where B5 stops paying (``quantize.W4_KERNEL_MAX_ROWS``): at each
    row count of ``ROUTE_ROWS`` (the captured rows repeated), B5 against
    ``quantize.dense``'s other route, the weight dequantized whole and one
    bf16 product, the dequantization counted; both in CUDA graphs over
    two weight copies.  Returns one dict a row count."""
    import torch

    from bcg_tpu_torch.models.quantize import dequantize_int4
    from bcg_tpu_torch.ops import w4_matmul as w4

    ws = [(q4, gscale), (q4.clone(), gscale.clone())]
    out = []
    for M in ROUTE_ROWS:
        xm = x[torch.arange(M, device=x.device) % x.shape[0]].contiguous()
        b5 = graph_ms([lambda q=q, g=g: w4.w4a16_matmul_cuda(xm, q, g) for q, g in ws], 20)
        route = graph_ms([lambda q=q, g=g: xm @ dequantize_int4({"q4": q, "gscale": g})
                          for q, g in ws], 4)
        out.append(dict(M=M, b5_ms=b5, dequantize_matmul_ms=route))
    del ws
    return out


def w4a16_check(captured):
    """B5 at P9's largest call (the LM head at M = 10), then at one
    captured weight of each layer shape with M = 1, 10, 50 and 256 rows
    (the captured rows repeated), and each layer shape's route crossover
    (``w4_route``).  ``captured``: P9's captured inputs."""
    import torch

    x, q4, gscale = captured["w4a16_matmul"]
    head = w4_line(x, q4, gscale)
    extra, routes = [], []
    shapes = sorted(k[1] for k in captured if isinstance(k, tuple))
    for shape in shapes:
        xc, q, g = captured[("w4a16_matmul", shape)]
        for M in (1, 10, 50, 256):
            xm = xc[torch.arange(M, device=xc.device) % xc.shape[0]].contiguous()
            extra.append(w4_line(xm, q, g))
        if shape[1] != q4.shape[1]:             # the LM head never takes prefill rows here
            routes.append(dict(shape=[2 * shape[0], shape[1]], rows=w4_route(xc, q, g)))
        torch.cuda.empty_cache()
    return dict(replaces="bcg_tpu/ops/w4_matmul.py:37 _w4_kernel (pallas_call :116 of "
                         "_w4a16_2d :107, via w4a16_matmul :150)",
                **head, shapes=extra, routes=routes)


def compact_sampler_call(call):
    """The sampler call ``call`` with its min_budget rows gathered into a
    ``[1, B, V]`` table that ``dfa_ids`` 0 and ``states`` 0..B-1 index:
    the same function of the same data, without copying the whole table."""
    import torch

    logits, minb, dfa_ids, states, meta_i, meta_f, eos_id, top_p = call
    B = logits.shape[0]
    rows = minb[dfa_ids.long(), states.long()][None].contiguous()
    return (logits, rows, torch.zeros_like(dfa_ids),
            torch.arange(B, dtype=torch.int32, device=logits.device), meta_i, meta_f,
            eos_id, top_p)


def save_sampler_inputs(call, path):
    """P1's captured sampler call, compacted, written to ``path`` on the CPU."""
    import torch

    logits, rows, dfa_ids, states, meta_i, meta_f, eos_id, top_p = compact_sampler_call(call)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(dict(logits=logits.cpu(), min_budget=rows.cpu(), dfa_ids=dfa_ids.cpu(),
                    states=states.cpu(), meta_i=meta_i.cpu(), meta_f=meta_f.cpu(),
                    eos_id=int(eos_id), top_p=float(top_p)), path)
    print(f"sampler inputs: P1's call {list(logits.shape)} written to {path}", flush=True)


def phase_kernels(inputs, counts, only=None):
    """Each kernel form against its plain version on its home path's
    captured inputs.  ``inputs``/``counts``: per path.  ``only``: just the
    entries held at that path's captured calls (``--only``)."""
    import torch
    import torch.nn.functional as F

    from bcg_tpu_torch.models.quantize import W4_KERNEL_MAX_ROWS
    from bcg_tpu_torch.ops import attention, decode_attention as da, guided_sampler

    results = []
    errors = []

    def common(name, path=None):
        """A form's identity and launches: at its home path (``name``), or
        at another path's captured call (``name@path``, that path's
        launches)."""
        src = "decode_attention_int8" if name == "chunk_decode_attention_int8" else name
        if name.startswith("paged_"):
            src = "paged_attention"
        if name == "w4a16_matmul":
            src = "w4a16"
        per_path = {p: c[name] for p, c in counts.items()}
        # A form on no game path reports its launches summed over the paths.
        launches = per_path.get(HOME[name], 0) if name in HOME else sum(per_path.values())
        if path is not None and path != HOME.get(name):
            name, launches = f"{name}@{path}", per_path[path]
        return dict(name=name, route="cuda", source=f"bcg_tpu_torch/csrc/{src}.cu",
                    launches=launches, launches_per_path=per_path)

    def flash(path="P1"):
        q, k, v, mask, scale = inputs[path]["flash_prefill"]
        out = attention.flash_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = per_row(attention.flash_attention_plain, q, k, v, mask, scale)
        dropped = per_row(attention.flash_attention_plain, q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        del out, ref, dropped
        ms = time_ms(lambda: attention.flash_attention_cuda(q, k, v, mask, scale))
        extra = {}
        if path != "P1":
            extra["graph_ms"] = graph_ms([lambda: attention.flash_attention_cuda(
                q, k, v, mask, scale)])
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
        return dict(common("flash_prefill", path),
                    replaces="bcg_tpu/ops/attention.py:37 _flash_kernel",
                    **check, ms=ms, **extra, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=lib_ms, library_ratio=ms / lib_ms, shape=[B, T, H, Hkv, S],
                    live_pairs=live)

    def decode(path="P1"):
        # A mesh rank's call carries the split plan's shape (P14).
        q, k, v, mask, scale, *plan = inputs[path]["decode_attention"]
        plan = plan[0] if plan else None
        B, H, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        m3 = mask if mask.dim() == 3 else mask[:, None]
        split = list(da._split_for(q, Hkv, S, m3.shape[1], plan=plan))
        # B * Hkv blocks filling two an SM leave nothing to split.
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        one_split = (plan[0] * plan[1] if plan else B * Hkv) >= 2 * sms
        out = da.decode_attention_cuda(q, k, v, mask, scale, plan)
        torch.cuda.synchronize()
        ref = da.decode_attention_plain(q, k, v, mask, scale)
        dropped = da.decode_attention_plain(q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (-1,), dropped)
        # The split arithmetic's plain version at the plan the kernel used.
        split_check(check, out, da.decode_attention_split_plain(q, k, v, mask, scale, *split),
                    (-1,))
        # A call takes tens of microseconds: time it in a CUDA graph of
        # calls (the event-timed single call counts the wrapper's host
        # time), and SDPA the same way.  K and V of the captured window
        # (100+ MB each) exceed the L2, so each call reads them cold.
        ms = graph_ms([lambda: da.decode_attention_cuda(q, k, v, mask, scale, plan)])
        event_ms = time_ms(lambda: da.decode_attention_cuda(q, k, v, mask, scale, plan), reps=50)
        plain_ms = time_ms(lambda: da.decode_attention_plain(q, k, v, mask, scale))
        group = H // Hkv
        m2 = mask if mask.dim() == 2 else mask[:, 0]
        kt = k.transpose(1, 2).repeat_interleave(group, 1)
        vt = v.transpose(1, 2).repeat_interleave(group, 1)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q[:, :, None], kt, vt, attn_mask=m2[:, None, None], scale=scale)
        lib_ms = graph_ms([sdpa])
        lib_event_ms = time_ms(sdpa, reps=50)
        valid = m2.sum().item()
        byts = 2 * (2 * valid * Hkv * Dh) + 2 * 2 * q.numel() + m2.numel()
        bms, by = bound(byts, 4 * Dh * H * valid)
        if one_split and split[0] != 1:
            check["ok"] = False
            errors.append(f"decode_attention at B = {B}: {split[0]} splits, not one")
        return dict(common("decode_attention", path),
                    replaces="bcg_tpu/ops/decode_attention.py:57 _decode_kernel",
                    **check, ms=ms, **({"graph_ms": ms} if path != "P1" else {}),
                    event_ms=event_ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms, library_event_ms=lib_event_ms,
                    library_ratio=ms / lib_ms, split=split, shape=[B, H, Hkv, S],
                    valid_slots=valid)

    def chunk():
        # The wrapper passes its split plan's shape (None on one device).
        q, k, v, mask, scale, *_ = inputs["P3"]["chunk_decode_attention"]
        split = list(da.chunk_split_plan(q, k, mask))
        out = da.chunk_decode_attention_cuda(q, k, v, mask, scale)
        torch.cuda.synchronize()
        ref = da.chunk_decode_attention_plain(q, k, v, mask, scale)
        dropped = da.chunk_decode_attention_plain(q, k, v, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        split_check(check, out, da.decode_attention_split_plain(q, k, v, mask, scale, *split),
                    (1, 3))
        del out, ref, dropped
        ms = time_ms(lambda: da.chunk_decode_attention_cuda(q, k, v, mask, scale), reps=50)
        plain_ms = time_ms(lambda: da.chunk_decode_attention_plain(q, k, v, mask, scale))
        B, K, H, Dh = q.shape
        S, Hkv = k.shape[1], k.shape[2]
        group = H // Hkv
        kt = k.transpose(1, 2).repeat_interleave(group, 1)
        vt = v.transpose(1, 2).repeat_interleave(group, 1)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kt, vt, attn_mask=mask[:, None], scale=scale), reps=50)
        del kt, vt
        # Slots any chunk row of a batch row attends, read once; q, out
        # (bf16) and the [B, K, S] mask once.
        slots = mask.any(1).sum().item()
        kv_bytes = 2 * (2 * slots * Hkv * Dh)
        g_ms = cold_graph_ms(da.chunk_decode_attention_cuda, (q, k, v, mask, scale), kv_bytes)
        bms, by = bound(kv_bytes + 2 * 2 * q.numel() + mask.numel(),
                        4 * Dh * H * mask.sum().item())
        return dict(common("chunk_decode_attention"),
                    replaces="bcg_tpu/ops/decode_attention.py:381 _decode_kernel (chunk "
                             "pallas_call of chunk_decode_attention :308)",
                    **check, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms, split=split, shape=[B, K, H, Hkv, S],
                    valid_slots=slots)

    def int8_forms(name, path):
        # A mesh rank's call carries the split plan's shape (P15).
        q, k, v, ks, vs, mask, scale, *plan = inputs[path][name]
        plan = plan[0] if plan else None
        launch0 = getattr(da, f"{name}_cuda")

        def launch(*a):
            return launch0(*a, plan)

        plain = getattr(da, f"{name}_plain")
        split = list(da.int8_split_plan(q, k, mask, plan))
        out = launch(q, k, v, ks, vs, mask, scale)
        torch.cuda.synchronize()
        ref = plain(q, k, v, ks, vs, mask, scale)
        dropped = plain(q, k, v, ks, vs, drop_live_keys(mask), scale)
        head_dims = (1, 3) if q.dim() == 4 else (-1,)
        check = attention_check(out, ref, head_dims, dropped)
        split_check(check, out, da.decode_attention_split_plain(
            q, k, v, mask, scale, *split, k_scale=ks, v_scale=vs), head_dims)
        del out, ref, dropped
        ms = time_ms(lambda: launch(q, k, v, ks, vs, mask, scale), reps=50)
        plain_ms = time_ms(lambda: plain(q, k, v, ks, vs, mask, scale))
        Hkv, S, Dh = k.shape[1], k.shape[2], k.shape[3]
        H = q.shape[-2]
        m3 = mask if mask.dim() == 3 else mask[:, None]
        slots = m3.any(1).sum().item()
        # int8 k and v plus their two f32 scales per attended slot and kv
        # head, as stored; q, out (bf16) and the mask once.
        kv_bytes = slots * Hkv * (2 * Dh + 8)
        g_ms = cold_graph_ms(launch, (q, k, v, ks, vs, mask, scale), kv_bytes)
        bms, by = bound(kv_bytes + 2 * 2 * q.numel() + m3.numel(), 4 * Dh * H * m3.sum().item())
        return dict(common(name, path),
                    replaces=("bcg_tpu/ops/decode_attention.py:113 _decode_kernel_allheads "
                              "(pallas_call :182 of _quantized_attention :166, via "
                              + ("chunk_decode_attention :327-359)" if q.dim() == 4
                                 else "decode_attention :241-264)")),
                    **check, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None, split=split,
                    shape=list(q.shape[:-1]) + [Hkv, S], valid_slots=slots)

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

    def paged_inputs(name, path=None):
        """Captured inputs of a paged form (at ``path``'s call where given),
        or, for the forms no game path reaches, inputs made from another
        form's captured pool and table."""
        if path is not None:
            return inputs[path][name]
        if name in HOME:
            return inputs[HOME[name]][name]
        path, src = PAGED_DERIVED[name]
        q, entry, mask, scale, *_ = inputs[path][src]
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

    def paged(name, path=None):
        from bcg_tpu_torch.ops import paged_attention as pa

        lay = FORMS[name][3]
        step = name.startswith("paged_decode")
        # A mesh rank's call carries the split plan's shape (P15).
        q, entry, mask, scale, *plan = paged_inputs(name, path)
        plan = plan[0] if plan else None
        launch0 = pa.paged_decode_attention_cuda if step else pa.paged_chunk_attention_cuda

        def launch(*a):
            return launch0(*a, plan)

        plain = pa.paged_decode_attention_plain if step else pa.paged_chunk_attention_plain
        m3 = mask[:, None] if step else mask
        split = list(pa.split_plan(q, entry, m3, plan))
        out = launch(q, entry, mask, scale)
        torch.cuda.synchronize()
        ref = plain(q, entry, mask, scale)
        dropped = plain(q, entry, drop_live_keys(mask), scale)
        check = attention_check(out, ref, (1, 3), dropped)
        split_check(check, out, pa.paged_attention_split_plain(q, entry, mask, scale, *split),
                    (1, 3))
        del ref, dropped
        ms = time_ms(lambda: launch(q, entry, mask, scale), reps=50)
        plain_ms = time_ms(lambda: plain(q, entry, mask, scale))
        # The dense kernel over the gathered dense view of the same inputs
        # (int4: dequantized to bf16, as the dense int4 path serves it).
        dense = pa.paged_gather_entry(entry)
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
        kv_bytes = blocks * bs * Hkv * per_pos
        g_ms = cold_graph_ms(launch, (q, entry, mask, scale), kv_bytes)
        byts = kv_bytes + 2 * 2 * q.numel() + m3.numel() + 4 * tbl.numel()
        bms, by = bound(byts, 4 * Dh * H * m3.sum().item())
        src = PAGED_DERIVED.get(name) if path is None else None
        return dict(common(name, path),
                    replaces=("bcg_tpu/ops/paged_attention.py:341 _paged_kernel (pallas_call "
                              ":507 of _paged_pallas_attention :432, via "
                              + ("paged_decode_attention :221)" if step
                                 else "paged_chunk_attention :262)")),
                    **check, ms=ms, graph_ms=g_ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=None, split=split, dense_ms=dense_ms,
                    dense_rel_row=dense_rel_row,
                    dense_rel_head=dense_rel_head, live_blocks=blocks,
                    inputs_from=(f"{src[0]} {src[1]}" if src else path or HOME[name]),
                    shape=[B, Kq, H, Hkv, nblk * bs, bs])

    def sampler(path="P1"):
        logits, minb, dfa_ids, states, meta_i, meta_f, eos_id, _top_p = \
            inputs[path]["guided_sampler"]
        B, V = logits.shape
        # Mixed rows: even rows greedy, odd rows sampled; the game's own
        # per-row scalars otherwise.
        mi = meta_i.clone()
        mi[:, 2] = (torch.arange(B, device=mi.device) % 2 == 0).to(torch.int32)
        p1 = (logits, minb, dfa_ids, states, mi, meta_f)
        # A batch above one wave: the captured rows tiled, each copy with
        # its own uniform.
        nb = SAMPLER_BIG_BATCH
        reps = -(-nb // B)
        gen = torch.Generator(device=logits.device)
        gen.manual_seed(0)
        mf_big = meta_f.repeat(reps, 1)[:nb].contiguous()
        mf_big[:, 1] = torch.rand(nb, generator=gen, device=logits.device)
        big = (logits.repeat(reps, 1)[:nb].contiguous(), minb, dfa_ids.repeat(reps)[:nb],
               states.repeat(reps)[:nb], mi.repeat(reps, 1)[:nb].contiguous(), mf_big)
        mismatches, err = {}, 0
        # The big batch is P1's alone: P11's call is a merged batch already,
        # P12's the same rows as P1's.
        for label, args in ((path, p1),) + (((f"B{nb}", big),) if path == "P1" else ()):
            for top_p in (1.0, 0.9):
                tk, ak = guided_sampler.sample_rows_cuda(*args, eos_id, top_p)
                tp, ap = guided_sampler.sample_rows_plain(*args, eos_id, top_p)
                mismatches[f"{label} top_p {top_p}"] = (int((tk.long() != tp.long()).sum())
                                                        + int((ak != ap).sum()))
                err = max(err, int((tk.long() - tp.long()).abs().max()))
        del big
        # Timed on the compacted call: the same rows read, no table copies.
        p1 = compact_sampler_call(p1 + (eos_id, 1.0))[:6]
        plans = {f"top_p {tp}": guided_sampler.cuda_plan(logits.device, B, V, tp)._asdict()
                 for tp in (1.0, 0.9)}
        ms = time_ms(lambda: guided_sampler.sample_rows_cuda(*p1, eos_id, 1.0), reps=50)
        ms_topp = time_ms(lambda: guided_sampler.sample_rows_cuda(*p1, eos_id, 0.9), reps=50)
        plain_ms = time_ms(lambda: guided_sampler.sample_rows_plain(*p1, eos_id, 1.0), reps=5)
        byts = B * V * (4 + 2) + meta_i.numel() * 4 + meta_f.numel() * 4 + B * 8
        g_ms, g_ms_topp = (cold_graph_ms(guided_sampler.sample_rows_cuda, p1 + (eos_id, tp),
                                         B * V * (4 + 2)) for tp in (1.0, 0.9))
        bms, by = bound(byts, 0)
        total = sum(mismatches.values())
        return dict(common("guided_sampler", path),
                    replaces="bcg_tpu/ops/guided_sampler.py:93 _sampler_kernel",
                    max_abs_err=float(err), token_mismatches=mismatches, ok=total == 0,
                    ms=ms, graph_ms=g_ms, topp_event_ms=ms_topp, topp_graph_ms=g_ms_topp,
                    plan=plans, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    library_ms=None, shape=[B, V])

    def w4a16():
        return dict(common("w4a16_matmul"), **w4a16_check(inputs["P9"]))

    def w4a16_p15():
        """B5 at a tp rank's sharded calls: its LM head (N = 75,968) and
        its w_down (K = 6144), at the captured rows."""
        cap = inputs["P15"]
        head = w4_line(*cap["w4a16_matmul"])
        # w_down's local shape: K 6144 packed into 3072 rows, N 4096.
        shapes = [w4_line(*args) for key, args in cap.items()
                  if isinstance(key, tuple) and key[1] == (3072, 4096)]
        return dict(common("w4a16_matmul", "P15"),
                    replaces="bcg_tpu/ops/w4_matmul.py:37 _w4_kernel (pallas_call :116 of "
                             "_w4a16_2d :107, via w4a16_matmul :150)",
                    **head, shapes=shapes, routes=[])

    home = [flash, decode, sampler, chunk,
            lambda: int8_forms("decode_attention_int8", "P4"),
            lambda: int8_forms("chunk_decode_attention_int8", "P2"),
            *[lambda n=f"paged_{form}_attention_{lay}": paged(n)
              for form in ("decode", "chunk") for lay in PAGED_LAYOUTS], w4a16]
    others = [(p, lambda f=f, p=p: f(p)) for p in ("P11", "P12", "P13", "P14")
              for f in (flash, decode, sampler) if p in inputs]
    if "P15" in inputs:
        others += [("P15", w4a16_p15),
                   ("P15", lambda: int8_forms("chunk_decode_attention_int8", "P15")),
                   ("P15", lambda: paged("paged_chunk_attention_int8", "P15"))]
    # ``only``: the entries of one path's captured calls (``--only``).
    for phase in ([ph for p, ph in others if p == only] if only
                  else home + [ph for _, ph in others]):
        results.append(phase())
        torch.cuda.empty_cache()
    if not only:
        extra = flash_p5()
        print(f"kernel {extra['name']}: rel_row={extra['rel_row']:.4g} (tol {ATTN_REL_ROW_TOL}) "
              f"rel_head={extra['rel_head']:.4g} (tol {ATTN_REL_HEAD_TOL}) with {DROP_KEYS} "
              f"live keys dropped: rel_row={extra['dropped_rel_row']:.4g} "
              f"rel_head={extra['dropped_rel_head']:.4g} right_padded_rows="
              f"{extra['right_padded_rows']} shape={extra['shape']}", flush=True)
        if not extra["ok"]:
            errors.append("flash_prefill at P5's right-padded input disagrees with its plain "
                          "version")
    for r in results:
        if r["name"].startswith("w4a16_matmul"):
            for e in [r] + r["shapes"]:
                print(f"kernel {r['name']}: shape[M,D,F]={e['shape']} group={e['group']} "
                      f"rel_row={e['rel_row']:.4g} (tol {W4_REL_ROW_TOL}) "
                      f"max_abs_err={e['max_abs_err']:.4g} ms={e['ms']:.4f} "
                      f"plain_ms={e['plain_ms']:.4f} bound_ms={e['bound_ms']:.4f} "
                      f"({e['bound_by']}) library_ms={fmt(e['library_ms'])} "
                      f"library_rel_row={fmt(e['library_rel_row'])} "
                      f"library_error={e['library_error']} dequantized_bf16_matmul_ms="
                      f"{e['dequantized_bf16_matmul_ms']:.4f} launches={r['launches']} "
                      f"per_path={json.dumps(r['launches_per_path'])}", flush=True)
                if not e["ok"]:
                    errors.append(f"{r['name']} at {e['shape']}: disagrees with its plain "
                                  "version")
            for rt in r["routes"]:
                # The fewest rows at which the dequantize route is faster (None: never).
                cross = next((e["M"] for e in rt["rows"]
                              if e["dequantize_matmul_ms"] < e["b5_ms"]), None)
                print(f"kernel w4a16_matmul route: shape[D,F]={rt['shape']} crossover_rows="
                      f"{cross} (W4_KERNEL_MAX_ROWS {W4_KERNEL_MAX_ROWS}) "
                      + " ".join(f"M={e['M']}: b5_ms={e['b5_ms']:.4f} dequantize_matmul_ms="
                                 f"{e['dequantize_matmul_ms']:.4f}" for e in rt["rows"]),
                      flush=True)
            continue
        if "rel_row" in r:
            err = (f"max_abs_err={r['max_abs_err']:.4g} ref_rms={r['ref_rms']:.4g} "
                   f"ref_max={r['ref_max']:.4g} rel_row={r['rel_row']:.4g} "
                   f"(tol {ATTN_REL_ROW_TOL}) rel_head={r['rel_head']:.4g} "
                   f"(tol {ATTN_REL_HEAD_TOL}) with {DROP_KEYS} live keys dropped: "
                   f"rel_row={r['dropped_rel_row']:.4g} rel_head={r['dropped_rel_head']:.4g}")
        else:
            err = (f"token_mismatches={json.dumps(r['token_mismatches'])} (tol 0) "
                   f"plan={json.dumps(r['plan'])}")
        if "dense_ms" in r:
            err += (f" dense_ms={r['dense_ms']:.4f} dense_rel_row={r['dense_rel_row']:.4g} "
                    f"live_blocks={r['live_blocks']} inputs_from={r['inputs_from']}")
        if "split" in r:
            err += (f" split={r['split']} split_plain_rel_row={r['split_rel_row']:.4g} "
                    f"split_plain_rel_head={r['split_rel_head']:.4g}")
        for key in ("event_ms", "library_event_ms", "graph_ms", "topp_event_ms",
                    "topp_graph_ms", "library_ratio"):
            if key in r:
                err += f" {key}={r[key]:.4g}"
        print(f"kernel {r['name']}: {err} "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={fmt(r['library_ms'])} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) launches={r['launches']} "
              f"per_path={json.dumps(r['launches_per_path'])} shape={r['shape']}", flush=True)
        if not r["ok"]:
            errors.append(f"{r['name']}: disagrees with its plain version")
    return results, errors


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--save-sampler-inputs", metavar="FILE",
                        help="also write P1's captured sampler call to FILE (torch.save), "
                             "the input of python -m bcg_tpu_torch.tools.sampler_kernel "
                             "--inputs FILE")
    parser.add_argument("--save-census", metavar="FILE",
                        help="also write P10's decode-step census to FILE (JSON), the "
                             "input of python -m bcg_tpu_torch.tools.census_gate "
                             "--update-cuda FILE")
    parser.add_argument("--only", choices=("mesh", "p16"),
                        help="mesh: build, make the weights and run only the mesh paths "
                             "(P14, P15) and their kernel entries; p16: build and run only "
                             "P16 (development loops: no ok line, exit 4)")
    args = parser.parse_args()
    SAVE["census"] = args.save_census
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
    if args.only == "p16":
        t0 = time.perf_counter()
        phase_p16()
        print(f"phase P16: {time.perf_counter() - t0:.1f} s", flush=True)
        print("chip_smoke --only p16: passed (not a whole run)", flush=True)
        return 4
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
    if args.only:
        t0 = time.perf_counter()
        for path, (c, got) in phase_mesh(params).items():
            counts[path], inputs[path] = c, got
        print(f"phase P14 + P15: {time.perf_counter() - t0:.1f} s", flush=True)
        del params
        torch.cuda.empty_cache()
        results, errors = [], []
        for path in ("P14", "P15"):
            res, err = phase_kernels(inputs, counts, only=path)
            results += res
            errors += err
        print(json.dumps({"kernels": results}, default=str), flush=True)
        if errors:
            fail("; ".join(errors))
        print("chip_smoke --only mesh: passed (not a whole run)", flush=True)
        return 4
    for path in PATHS:
        t0 = time.perf_counter()
        counts[path], inputs[path] = phase_path(path, params)
        print(f"phase {path}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts["P13"], inputs["P13"] = phase_p10(params)
    print(f"phase P10 (P13 included): {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # The captured inputs wait in host memory while P11 runs: the served
    # engine's row cap reads the card's whole memory, and a merged batch
    # of 40 rows needs it.
    inputs = move_inputs(inputs, "cpu")
    counts["P11"], inputs["P11"] = phase_p11(params)
    inputs = move_inputs(inputs, DEVICE)
    print(f"phase P11: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_reports()
    print(f"phase reports: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    counts["P12"], inputs["P12"] = phase_p12(params)
    print(f"phase P12: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    # The captured inputs wait in host memory while P14's, P15's and P16's
    # ranks share the card.
    inputs = move_inputs(inputs, "cpu")
    for path, (c, got) in phase_mesh(params).items():
        counts[path], inputs[path] = c, got
    print(f"phase P14 + P15: {time.perf_counter() - t0:.1f} s", flush=True)
    # P16's two ranks each make the whole tree on the card: the shared
    # weights, which no later phase reads, go first.
    del params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_p16()
    print(f"phase P16: {time.perf_counter() - t0:.1f} s", flush=True)
    inputs = move_inputs(inputs, DEVICE)
    if args.save_sampler_inputs:
        save_sampler_inputs(inputs["P1"]["guided_sampler"], args.save_sampler_inputs)
    t0 = time.perf_counter()
    results, errors = phase_kernels(inputs, counts)
    print(f"phase kernels: {time.perf_counter() - t0:.1f} s", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card line", flush=True)
    extra_keys = ("graph_ms", "split", "topp_graph_ms", "plan")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + extra_keys if k in r}
                                  for r in results]}), flush=True)
    if errors:
        fail("; ".join(errors))
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
