"""PyTorch inference engine — the port of ``bcg_tpu/engine/jax_engine.py``
(the lockstep, dense-cache path).

Serving design, as in the JAX engine:

* One padded batch per game phase; prompts are LEFT-padded into length
  buckets so every call runs one of a few shapes (the same buckets as the
  JAX engine, so both engines run the same shapes).
* The static per-role system prompt is prefilled ONCE into a prefix KV
  entry and reused by every round's calls; only the round suffix is
  prefilled per call (prefix caching).
* Decode is a token loop over ``decode_step`` and the fused guided
  sampler, with the JAX loop's semantics: the first token comes from the
  prefill logits, cache slot ``L+i`` opens per step, finished rows are
  fed EOS, the output is EOS-filled, the last slot is ``max_new-1``, and
  dead-end rows are forced to EOS.  The host checks for "all rows done"
  every :data:`_DONE_CHECK` steps instead of every step (the extra steps
  only rewrite EOS into finished rows), so the card is not idled by a
  synchronisation per token.
* Two more decode loops, as in the JAX engine: forced-chain
  fast-forward (``decode_fast_forward``: each step carries the sampled
  token plus its DFA-forced continuation, :meth:`_ff_decode_loop`) and
  prompt-lookup speculative decoding (``spec_decode``,
  ``engine/speculative.spec_decode_loop``).  Their write positions and
  per-row counts stay on the device: the only host read in any loop is
  the "all rows done" poll.
* The dense KV cache is bf16, int8 with per-(position, kv head) scales
  (``kv_cache_dtype="int8"``) or packed int4 with bf16 scales
  (``"int4"``, which warns: the dense int4 slab is dequantized whole
  every step, as in the JAX package), under all three loops.
* The block-paged KV cache (``paged_kv`` / ``BCG_TPU_PAGED_KV=1``,
  ``engine/paged_kv.PagedKV``): one preallocated block pool per layer
  and a block table per row; prompt prefixes are matched by token
  content in a radix tree, stored once and shared across rows and
  rounds, and only each row's unmatched tail is prefilled (right-padded,
  so full blocks of real tokens can be shared).  Over bf16, int8 and
  int4 pools, under all three loops; each call frees its private blocks
  and unpins its radix paths in a ``finally``.
* Weights are bf16, or quantized (``quantization="int8"``: dynamic
  W8A8 on every dense matmul and the LM head; ``"int4"``: grouped W4A16,
  whose decode-shaped products run the B5 kernel), under every loop and
  KV layout (:mod:`bcg_tpu_torch.models.quantize`).  An owned tree is
  quantized leaf by leaf as it is made; a shared bf16 tree is quantized
  into the engine's own copy.
* Attention, sampling and the int4 matmul run the port's hand-written
  CUDA kernels on a CUDA device, and their plain versions on the CPU
  (tests).

* Weights of a ``bcg-tpu/*`` preset are random, made on the device; any
  other model boots from its local checkpoint (``models/loader.py``) or
  pre-quantized artifact (``models/artifact.py``), found as the JAX engine
  finds it.
* The JAX engine's observability seams (``bcg_tpu_torch/obs``): the
  ``engine.prefill`` / ``engine.decode`` spans, the host-sync seams (and
  the loops' ``done_poll``), the ``pad_batch`` shape signature, the
  launch census of one decode step, the device-memory ledger's
  ``params`` / ``prefix_cache`` / ``kv_cache`` / ``spec_slots`` accounts
  and the ``engine.spec.*`` counters.  With every flag off they do no
  device work and add no host sync.

* The fused mega-round (:meth:`TorchEngine.run_megaround`,
  ``engine/megaround.py``): a whole consensus round as one eager program
  over device tensors of game state — the suffix prefill against a
  per-plan prefix cache, the plain loop with no poll, the on-device parse,
  exchange, tally and consensus — with one host sync, its packed
  readback.  Dense engines only, as in the JAX package.

* Tensor, sequence and data parallelism (``tensor_/sequence_/
  data_parallel_size``) for every engine the port serves on one device —
  bf16, int8 or int4 weights, a dense bf16, int8 or int4 cache or a paged
  pool, the plain, fast-forward and speculative loops — over a ``("dp",
  "tp", "sp")`` mesh of ranks (``parallel/``; one process and device a
  rank, every rank running the same game).  As in the JAX engine a dense
  int4 cache or a paged pool with ``sp`` raises ``ValueError``.  Each rank
  holds its slices of the weights (``parallel/sharding.py``; quantized
  whole, then sliced) and of the caches: kv heads over ``tp``, the
  sequence over ``sp`` (caches aligned to ``sp``; a full prefill goes round
  the ring, a prefix-cached suffix and the decode steps merge the slices),
  batch rows over ``dp`` (the batch padded to a multiple of ``dp``; each
  ``dp`` rank prefills and decodes its rows, then the outputs are gathered
  so every rank parses the same rows).  The kernels run at the local
  shapes; the sampler runs on the gathered logits with the same generator
  on every rank, so every rank samples the same tokens, and every branch
  of a loop (drafts, acceptances, done polls) reads values that are the
  same on every rank of a tp or sp group.  A paged pool splits its kv
  heads over ``tp`` and replicates over ``dp``: each dp rank assembles the
  whole batch's tables and writes every row's k/v (gathered over ``dp``),
  and its done polls read every rank's rows, so the ranks' pools stay
  equal and their loops take the same steps.

Served: bf16, int8 and int4 weights, a dense or paged bf16, int8 or int4
KV cache, the plain, fast-forward and speculative loops and the fused
mega-round, each on one device and each but the fused round under the
mesh above.  Under a mesh the engine refuses what the JAX engine
refuses, with its ``ValueError``: a paged pool with ``sp`` and a dense
int4 cache with ``sp`` (and the fused round raises
``MegaroundUnsupported``, so the orchestrator plays lockstep).  No knob
is ignored.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
import warnings
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bcg_tpu_torch.config import env_flag
from bcg_tpu_torch.engine.chat_template import (
    format_chat_parts,
    format_chat_parts3,
    format_chat_prompt,
    prefix_split_safe,
)
from bcg_tpu_torch.engine.interface import InferenceEngine, per_row_settings as _per_row
from bcg_tpu_torch.engine.paged_kv import PagedKV
from bcg_tpu_torch.engine.tokenizer import Tokenizer, tokenizer_for_model
from bcg_tpu_torch.engine.speculative import spec_decode_loop, spec_decode_slots
from bcg_tpu_torch.guided.processor import FF_CHUNK, GuidedBatch, compile_schema
from bcg_tpu_torch.models.configs import ModelSpec, spec_for_model
from bcg_tpu_torch.models.quantize import dense_route_from_env, leaf_nbytes
from bcg_tpu_torch.models.transformer import (
    decode_chunk,
    decode_step,
    init_kv_cache,
    prefill,
    prefill_chunk_at,
    prefill_paged,
    prefill_paged_chunk_at,
    prefill_sp,
    prefill_with_prefix,
)
from bcg_tpu_torch.obs import (
    compile as obs_compile,
    counters as obs_counters,
    hlo as obs_hlo,
    hostsync as obs_hostsync,
    ledger as obs_ledger,
    tracer as obs_tracer,
)
from bcg_tpu_torch.ops.guided_sampler import make_fused_sampler, sample_rows
from bcg_tpu_torch.parallel.collectives import all_gather, all_reduce
from bcg_tpu_torch.runtime import envflags, metrics as _metrics, resilience

# Bucket ladders: identical to the JAX engine's (see jax_engine.py for
# the reasoning behind each rung).
_LEN_BUCKETS = (512, 1024, 2048, 4096, 6144, 8192)
_SUFFIX_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
_SUFFIX_BUCKETS_FINE = (256, 512, 1024, 1536, 2048, 3072, 4096, 8192)
_PREFIX_BUCKETS = (128, 256, 512, 768, 1024, 1536, 1792, 2048, 4096, 6144, 8192)

# Decode-loop steps between host checks for "every row finished".
_DONE_CHECK = 8

_TIMING = env_flag("BCG_TPU_TIMING")


class BudgetError(ValueError):
    """A request whose token budget cannot fit the context window — the
    ONLY generation-time error the engine turns into per-row
    ``{"error": ...}`` results; anything else propagates."""


def _ff_decode_slots(max_new: int) -> int:
    """Cache tail allocation for the fast-forward loop's compacted writes:
    the write position advances by 1 + the widest row chain per
    iteration, with the in-loop capacity guard falling back to single-token
    advances whenever the worst-case remainder would no longer fit, so
    1.5x the token budget plus two chunk windows always suffices."""
    return (3 * max_new) // 2 + 2 * FF_CHUNK


def _pad_batch(real_B: int, multiple: int = 1) -> int:
    """Batch-size bucketing: small (retry) batches round up to a power of
    two; full-size game batches stay exact; then up to a multiple of the
    ``dp`` degree, so the rows split evenly over the ``dp`` ranks."""
    B = real_B if real_B >= 8 else 1 << (real_B - 1).bit_length()
    return B + (-B) % multiple


def _chunk_size(cap: int, multiple: int = 1) -> int:
    """Largest chunk whose padded batch stays within ``cap``."""
    return max(s for s in range(1, cap + 1) if _pad_batch(s, multiple) <= cap)


def _pad_rows(*lists, multiple: int = 1):
    """Pad parallel per-sequence lists to the bucketed batch size by
    repeating row 0 (padding rows' results are discarded).
    Returns (real_B, B, *padded_lists)."""
    real_B = len(lists[0])
    B = _pad_batch(real_B, multiple)
    return (real_B, B) + tuple(l + [l[0]] * (B - real_B) for l in lists)


def _resolve_device(device) -> torch.device:
    """``None`` means CUDA.  A CUDA device without a card raises — the
    engine never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "TorchEngine: no CUDA device is available; pass device='cpu' "
            "to run on the CPU"
        )
    return dev


def _rank_device(asked: torch.device, rank_dev: torch.device) -> torch.device:
    """Under a mesh the engine runs on its rank's device: the one asked
    for (``_resolve_device``'s) must be of that device's type, and of its
    index when it names one."""
    if asked.type != rank_dev.type or (asked.index is not None and asked != rank_dev):
        raise ValueError(f"TorchEngine: device {asked} asked for, but this rank's "
                         f"torch.distributed world runs it on {rank_dev}")
    return rank_dev


def _check_sp(kv_dtype: str, paged: bool, sp: int) -> None:
    """The JAX engine's two refusals under sequence parallelism, in its
    order and words: a dense int4 cache (the ring's slices dequantize int8
    scales only) and a paged pool (its blocks are shared across rows, so
    the sequence cannot split)."""
    if sp <= 1:
        return
    if kv_dtype == "int4":
        raise ValueError(
            "kv_cache_dtype='int4' does not compose with sequence "
            f"parallelism (sp={sp}): the sp ring decode "
            "kernels dequantize unpacked int8 scales only"
        )
    if paged:
        raise ValueError(
            "paged_kv does not compose with sequence parallelism "
            f"(sp={sp}) yet: pool blocks are shared "
            "across rows so the sequence dim cannot shard"
        )


def _resolve_paged_impl(raw: str, device: torch.device) -> str:
    """``paged_kv_impl`` the port's way: on CUDA, ``auto`` and ``pallas``
    both mean the paged kernel (``"cuda"``) and ``xla`` — the gather
    oracle — raises, so the served path never runs a plain version on
    the card; on the CPU every value runs the plain gather version
    (``"plain"``)."""
    raw = (raw or "auto").strip().lower()
    if raw not in ("auto", "xla", "pallas"):
        raise ValueError(f"paged_kv_impl={raw!r}: expected 'auto', 'xla' or 'pallas'")
    if device.type != "cuda":
        return "plain"
    if raw == "xla":
        raise ValueError(
            "paged_kv_impl='xla': the PyTorch engine runs the paged attention "
            "kernel on CUDA ('auto'); the gather oracle serves CPU tensors only"
        )
    return "cuda"


class TorchEngine(InferenceEngine):
    def __init__(self, config, device=None, params=None,
                 spec: Optional[ModelSpec] = None, mesh=None):
        self.config = config
        self.spec = spec or spec_for_model(config.model_name)
        if self.spec is None:
            raise ValueError(f"No architecture spec for model {config.model_name!r}")
        self.kv_cache_dtype = self._check_config(config)
        # The mesh (parallel/): given, or built over the world the config's
        # sizes name (a clear error when no world of that size exists).
        if mesh is None and any(self._mesh_sizes(config)):
            from bcg_tpu_torch.parallel.mesh import mesh_from_engine_config

            mesh = mesh_from_engine_config(config)
        self.mesh = mesh
        self.device = _resolve_device(device)
        if mesh is not None:
            from bcg_tpu_torch.parallel import distributed

            self.device = _rank_device(self.device, distributed.device())
        self.kv_int8 = self.kv_cache_dtype == "int8"
        # False | "int8" | "int4": the ``quantized=`` argument of every
        # cache and pool allocation.
        self.kv_quantized = False if self.kv_cache_dtype == "bfloat16" else self.kv_cache_dtype
        if self.kv_cache_dtype == "int4":
            from bcg_tpu_torch.models.quantize import kv_int4_layout

            kv_int4_layout(self.spec.head_dim)   # even-head-dim boot check
        # A non-preset model boots from a local checkpoint: found first,
        # so a missing one raises FileNotFoundError before anything else
        # is built; the tokenizer and the weights both come from it.
        self._ckpt_dir = None
        if params is None and not config.model_name.startswith("bcg-tpu/"):
            from bcg_tpu_torch.models.loader import require_checkpoint_dir

            self._ckpt_dir = require_checkpoint_dir(config.model_name)
        self.tokenizer: Tokenizer = tokenizer_for_model(config.model_name, self._ckpt_dir)
        self.max_model_len = config.max_model_len
        self.prefill_chunk = int(getattr(config, "prefill_chunk", 0) or 0)
        if self.prefill_chunk < 0:
            raise ValueError(
                f"prefill_chunk={self.prefill_chunk}: expected 0 (disabled) "
                "or a positive token count"
            )
        self._suffix_buckets = (
            _SUFFIX_BUCKETS_FINE
            if (getattr(config, "fine_suffix_buckets", False)
                or env_flag("BCG_TPU_FINE_SUFFIX"))
            else _SUFFIX_BUCKETS
        )

        self.quantization = config.quantization
        # Where each quantized product goes, resolved from the env flags
        # once and carried on the spec into every forward pass.
        route = dense_route_from_env()
        if self.quantization == "int4" and not route.w4_kernel and self.device.type == "cuda":
            raise ValueError(
                "BCG_TPU_DISABLE_W4_KERNEL: the PyTorch engine runs every "
                "decode-shaped int4 matmul through the W4A16 kernel on CUDA; "
                "the dequantize route serves CPU tensors only")
        par = None
        if self.mesh is not None:
            from bcg_tpu_torch.parallel.sharding import ModelParallel

            par = ModelParallel(self.spec, self.mesh)
        self.spec = dataclasses.replace(self.spec, dense_route=route, par=par)
        self._dp, self._sp = (par.dp, par.sp) if par is not None else (1, 1)
        # Rows the dp split could not take (a row cap below dp): each such
        # batch runs whole on every dp rank.  ``dp_batches`` counts the
        # batches that ran split over dp.
        self.dp_bypasses = 0
        self.dp_batches = 0
        self.sp_bypasses = 0
        self.params = self._load_params(params)
        # Compute dtype follows the weights (bf16 served; the CPU parity
        # tests pass f32 weights, as the JAX engine accepts them); the KV
        # cache is bf16 or int8 either way, as in the JAX engine.
        self.kv_dtype = torch.bfloat16
        self._param_bytes = sum(leaf_nbytes(w) for w in self.params.values())
        # Bytes of one cache slot of one layer: k and v, plus their two
        # scales per kv head (int8: 1-byte values, f32 scales; int4:
        # half-byte values, bf16 scales — half the int8 slot).
        Hkv, Dh = (par.kv_heads if par is not None else self.spec.num_kv_heads), self.spec.head_dim
        self._kv_slot_bytes = {"int8": Hkv * (2 * Dh + 8), "int4": Hkv * (Dh + 4)}.get(
            self.kv_cache_dtype, Hkv * Dh * 4)

        # Decode loops (see the module docstring).  Speculative decoding
        # supersedes fast-forward when both are set; the env flags
        # override the config fields, as in the JAX engine.
        self.fast_forward = bool(getattr(config, "decode_fast_forward", False))
        self.spec_decode = bool(getattr(config, "spec_decode", False)) or env_flag("BCG_TPU_SPEC")
        self.spec_k = (envflags.get_int("BCG_TPU_SPEC_K") if envflags.is_set("BCG_TPU_SPEC_K")
                       else int(getattr(config, "spec_k", 4)))
        self.spec_ngram = (envflags.get_int("BCG_TPU_SPEC_NGRAM")
                           if envflags.is_set("BCG_TPU_SPEC_NGRAM")
                           else int(getattr(config, "spec_ngram", 3)))
        if self.spec_decode and (self.spec_k < 1 or self.spec_ngram < 1):
            raise ValueError(
                f"spec_k={self.spec_k} / spec_ngram={self.spec_ngram}: "
                "speculative decoding needs both >= 1"
            )
        if self.quantization == "int8" and not self.fast_forward and not self.spec_decode:
            # W8A8 adds the activation's quantization launches to every
            # matmul; a single-token step pays them for one token a weight
            # pass.  Configuring that pairing should not be silent.
            warnings.warn(
                "quantization='int8' without decode_fast_forward: every matmul "
                "quantizes its activations first, which the single-token decode "
                "loop pays once per token on the card; enable decode_fast_forward "
                "(--fast-forward) so each weight pass carries a chunk of tokens",
                stacklevel=2,
            )

        # Sampling noise: an explicit generator on the engine's device
        # (the JAX engine's PRNGKey(fake_seed)).
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(getattr(config, "fake_seed", 0)))

        self.last_decode_steps = 0
        self.total_decode_steps = 0
        # Draft tokens proposed / accepted by the speculative loop, over
        # real rows (also the engine.spec.* counters).
        self.spec_drafted = 0
        self.spec_accepted = 0
        # Steps the plain loop takes for the same outputs (one per token
        # up to the batch's longest row): the fast-forward and
        # speculative loops' weight passes are measured against it.
        self.total_plain_steps = 0
        # Largest decode-batch KV cache allocated (bytes).
        self.max_kv_cache_bytes = 0
        self.total_rows = 0
        self.failed_rows = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.prefix_fallbacks = 0
        self._prefix_fallback_warned = False
        self._kv_budget_warned = False
        # Fused mega-round (engine/megaround.py): round programs memoized
        # per plan layout, the one resident plan's device arrays and
        # per-plan prefix caches, and the guided tables per (schema, n).
        self._megaround_programs: Dict[Tuple, Any] = {}
        self._megaround_arrays: Dict[int, Tuple] = {}
        self._megaround_guided_memo: Dict[Tuple, Any] = {}
        self.megaround_rounds = 0
        self.megaround_seconds = 0.0

        # Token-byte table padded to the MODEL vocab (pads are b'' =
        # forbidden, so logits and masks agree).
        self._token_bytes = self.tokenizer.token_bytes()
        if len(self._token_bytes) < self.spec.vocab_size:
            self._token_bytes += [b""] * (self.spec.vocab_size - len(self._token_bytes))
        elif len(self._token_bytes) > self.spec.vocab_size:
            raise ValueError(
                f"tokenizer vocab {len(self._token_bytes)} exceeds model vocab "
                f"{self.spec.vocab_size}"
            )

        # Prefix caching (see _get_prefix_entry).
        self.prefix_caching = getattr(config, "prefix_caching", True)
        self._prefix_safe = prefix_split_safe(config.model_name)
        self._prefix_cache: "OrderedDict[Tuple[str, int], Dict[str, Any]]" = OrderedDict()
        self._prefix_lens_memo: Dict[str, int] = {}
        self._prefix_bytes = 0
        self._prefix_active: set = set()
        self._prefix_over_budget_warned = False
        # Device memory: the card's total on CUDA; none on the CPU, where
        # the row provisioner stays off and the prefix cache gets a fixed
        # allowance.
        self._prefix_budget = 4 << 30
        self._mem_limit = (
            torch.cuda.mem_get_info(self.device)[1]
            if self.device.type == "cuda" else None
        )
        if self._mem_limit:
            free = self._mem_limit - self._param_bytes
            self._prefix_budget = min(4 << 30, max(256 << 20, int(free * 0.25)))
        # Device-memory ledger (obs/ledger.py): the card's capacity and
        # the weights, keyed by engine identity, so weight-sharing engines
        # each charge their share once and shutdown credits exactly it.
        obs_ledger.set_limit(self._mem_limit)
        obs_ledger.charge("params", id(self), self._param_bytes)

        # Block-paged KV cache (see the module docstring); the pool is
        # sized after the weights, from the card's memory.
        self.paged_kv = bool(getattr(config, "paged_kv", False)) or env_flag("BCG_TPU_PAGED_KV")
        self._paged: Optional[PagedKV] = None
        self._paged_call_private: List[int] = []
        self._paged_dirty = False
        self._paged_toks_memo: Dict[str, np.ndarray] = {}
        if self.kv_cache_dtype == "int4" and not self.paged_kv:
            warnings.warn(
                "kv_cache_dtype='int4' without paged_kv: the dense packed cache "
                "is dequantized whole every decode step, which is SLOWER than "
                "bfloat16 — enable BCG_TPU_PAGED_KV=1 (the paged kernel unpacks "
                "nibbles as it reads them) to get the capacity win without the "
                "dequant tax",
                stacklevel=2,
            )
        if self.paged_kv:
            self._init_paged(config)
        # A paged batch split over dp: every rank assembles the whole
        # batch's tables and takes every row's writes (PagedCache).
        self._dp_paged = self._paged is not None and self._dp > 1
        # Telemetry endpoint (BCG_TPU_METRICS_PORT) + fleet metric-shard
        # flusher (BCG_TPU_METRICS_SHARD_DIR): idempotent, off by default.
        from bcg_tpu_torch.obs import export as obs_export, fleet as obs_fleet

        obs_export.maybe_start_http_server()
        obs_fleet.maybe_start_shard_writer()

    # ------------------------------------------------------------ config

    @staticmethod
    def _check_config(config) -> str:
        """The JAX engine's config resolution, narrowed to what the port
        serves: every knob outside the ported path raises.  Returns the
        KV-cache dtype (``"bfloat16"``, ``"int8"`` or ``"int4"``)."""
        if getattr(config, "dtype", "bfloat16") not in ("bfloat16", "bf16"):
            raise ValueError(
                f"dtype={config.dtype!r}: serving computes in bfloat16"
            )
        kv_raw = (
            (envflags.get_str("BCG_TPU_KV_DTYPE") or "").strip().lower()
            or str(config.kv_cache_dtype).lower()
        )
        kv_raw = {"bf16": "bfloat16"}.get(kv_raw, kv_raw)
        if kv_raw not in ("bfloat16", "int8", "int4"):
            raise ValueError(
                f"kv_cache_dtype={kv_raw!r}: expected 'bfloat16'/'bf16', "
                "'int8' or 'int4'"
            )
        if config.quantization not in (None, "int8", "int4"):
            raise ValueError(
                f"quantization={config.quantization!r}: expected None, "
                "'int8' or 'int4'"
            )
        _check_sp(kv_raw, bool(getattr(config, "paged_kv", False))
                  or env_flag("BCG_TPU_PAGED_KV"),
                  int(getattr(config, "sequence_parallel_size", 1) or 1))
        # The port always runs its hand-written kernels: the plain
        # versions serve CPU tensors only, never a CUDA batch.
        if config.attention_impl not in ("auto", "pallas"):
            raise ValueError(
                f"attention_impl={config.attention_impl!r}: the PyTorch "
                "engine always runs its attention kernels ('auto')"
            )
        raw_fs = (
            (envflags.get_str("BCG_TPU_FUSED_SAMPLER") or "").strip().lower()
            or str(getattr(config, "fused_sampler", "auto") or "auto").lower()
        )
        if raw_fs not in ("auto", "pallas"):
            raise ValueError(
                f"fused_sampler={raw_fs!r}: the PyTorch engine always runs "
                "the fused sampler kernel ('auto')"
            )
        return kv_raw

    @staticmethod
    def _mesh_sizes(config) -> List[str]:
        """The mesh knobs set above 1, as ``name=value``."""
        return [f"{n}={getattr(config, n)}" for n in
                ("tensor_parallel_size", "data_parallel_size", "sequence_parallel_size")
                if int(getattr(config, n, 1) or 1) > 1]

    def _load_params(self, params):
        """The served weight tree (the JAX engine's boot section, without
        scan-over-layers).  An owned tree of a ``bcg-tpu/*`` preset is
        made on the device from seed 0; any other model loads its local
        checkpoint (``self._ckpt_dir``): a pre-quantized artifact
        (``models/artifact.py``, whose mode must be this engine's), else
        HF safetensors (``models/loader.py``).  Made or loaded, an owned
        tree is quantized leaf by leaf as it arrives when ``quantization``
        is set.  A shared tree (``params=``) must be bf16 or already in
        this engine's mode: a bf16 one is quantized into a new dict,
        leaving the donor's copy whole; a quantized one of another mode,
        or any quantized one under ``quantization=None``, raises.  Under a
        mesh every path gives the rank its slices of the one-device tree
        (the sharded quantizer quantizes each full leaf before slicing it,
        as the JAX engine quantizes before it shards)."""
        from bcg_tpu_torch.models.quantize import (
            weight_quantizer, ensure_quantized_head, is_int4, is_quantized, quantize_leaf_transform,
            quantize_params,
        )

        mode = self.quantization
        transform = quantize_leaf_transform(self.spec, mode, mesh=self.mesh) if mode else None
        if params is None and self._ckpt_dir is None:
            from bcg_tpu_torch.models.loader import init_random_params_sharded

            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = init_random_params_sharded(self.spec, gen, self.mesh, self.device,
                                                leaf_transform=transform)
        elif params is None:
            from bcg_tpu_torch.models import artifact
            from bcg_tpu_torch.models.loader import load_checkpoint_params

            if artifact.artifact_mode(self._ckpt_dir) is not None:
                params = artifact.load_quantized_artifact(
                    self.spec, self._ckpt_dir, mode, self.device, mesh=self.mesh)
            else:
                params = load_checkpoint_params(
                    self.spec, self.config.model_name, self.device,
                    leaf_transform=transform, ckpt_dir=self._ckpt_dir, mesh=self.mesh)
        else:
            wq = params["layers.0.wq"]
            tree_mode = ("int4" if is_int4(wq) else "int8") if is_quantized(wq) else None
            if tree_mode is not None and tree_mode != mode:
                raise ValueError(
                    f"constructor params are {tree_mode}-format but "
                    f"config.quantization={mode!r}; share weights only between "
                    "engines of the same mode")
            quantize = weight_quantizer(mode) if mode is not None and tree_mode is None else None
            if self.mesh is not None:
                from bcg_tpu_torch.parallel.sharding import shard_params

                params = shard_params(params, self.spec, self.mesh, quantize=quantize)
            elif quantize is not None:
                params = quantize_params(params, self.spec, consume=False, mode=mode)
        if mode is not None:
            ensure_quantized_head(params, self.spec, mode)
        return params

    def _init_paged(self, config) -> None:
        """The paged pool and its knobs (the JAX engine's boot section):
        block size and pool size from the env or the config (0 blocks =
        :meth:`_auto_pool_blocks`), the attention impl
        (:func:`_resolve_paged_impl`, resolved before the pool is
        allocated), the chunked-prefill size aligned up to the block size
        (paged history is gathered in whole table columns), and the
        entry-build scratch reserve."""
        impl = _resolve_paged_impl(
            envflags.get_str("BCG_TPU_PAGED_KV_IMPL")
            or str(getattr(config, "paged_kv_impl", "auto") or "auto"),
            self.device,
        )
        bs_blk = (envflags.get_int("BCG_TPU_KV_BLOCK_SIZE")
                  or int(getattr(config, "kv_block_size", 16) or 16))
        pool_blocks = (envflags.get_int("BCG_TPU_KV_POOL_BLOCKS")
                       or int(getattr(config, "kv_pool_blocks", 0) or 0))
        if pool_blocks <= 0:
            pool_blocks = self._auto_pool_blocks(bs_blk)
        self.paged_kv_impl = impl
        self._paged = PagedKV(self.spec, pool_blocks, bs_blk, quantized=self.kv_quantized,
                              device=self.device)
        if self.prefill_chunk:
            self.prefill_chunk += (-self.prefill_chunk) % bs_blk
        self._paged_scratch_blocks = self._paged_build_scratch_blocks()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device, dtype=dtype)

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the engine's device with no host sync: one
        non-blocking copy from pinned memory on CUDA (a pageable copy
        waits for the device); on the CPU, ``t`` itself."""
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _all_done(done: torch.Tensor, entry: str) -> bool:
        """The decode loops' "all rows done" poll: the only host read
        inside a loop, every :data:`_DONE_CHECK` steps (a seam of the
        host-sync audit)."""
        obs_hostsync.note("done_poll", entry=entry)
        with obs_hostsync.expected():
            return bool(done.all())

    def _done_poll(self, done: torch.Tensor, entry: str) -> bool:
        """The loops' done poll.  A paged batch split over ``dp`` writes
        every rank's rows at every step (a collective a layer), so its
        ranks must run the same steps: they poll whether every row of
        EVERY rank is done (one max over ``dp`` of a live flag)."""
        if not self._dp_paged:
            return self._all_done(done, entry)
        live = (~done).any().to(torch.int32).reshape(1)
        return self._all_done(all_reduce(live, self.mesh, "dp", op="max") == 0, entry)

    @staticmethod
    def _read_back(site: str, entry: str, t: torch.Tensor, n: int = 1) -> np.ndarray:
        """``t`` on the host, counted at ``site`` (``n`` syncs)."""
        obs_hostsync.note(site, n=n, entry=entry)
        with obs_hostsync.expected():
            return t.cpu().numpy()

    # ------------------------------------------------------------- tokenizing

    def _encode_leftpad(self, texts: List[str], limits: List[int],
                        bucket_ladder: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray, int]:
        """Tokenize (keeping the LAST ``limits[i]`` tokens per row) and
        LEFT-pad into a bucketed [B, L] batch (the JAX engine's ladder
        extension and clamping rules)."""
        token_lists = [
            self.tokenizer.encode(t)[-lim:] for t, lim in zip(texts, limits)
        ]
        max_len = max(len(t) for t in token_lists)
        max_limit = max(limits)
        buckets = list(bucket_ladder)
        while buckets[-1] < max_limit:
            buckets.append(buckets[-1] * 2)
        L = next((b for b in buckets if b >= max_len), max_limit)
        L = max(min(L, max_limit), max_len)
        B = len(token_lists)
        tokens = np.full((B, L), self.tokenizer.pad_id, dtype=np.int32)
        valid = np.zeros((B, L), dtype=bool)
        for i, toks in enumerate(token_lists):
            tokens[i, L - len(toks):] = toks
            valid[i, L - len(toks):] = True
        return tokens, valid, L

    def _prepare_batch(self, full_prompts: List[str], budgets: List[int]):
        """Tokenize + LEFT-pad, reserving each row's own decode budget."""
        limits = [self.max_model_len - b - 1 for b in budgets]
        if min(limits) < 1:
            raise BudgetError(
                f"max_tokens={max(budgets)} leaves no room for a prompt "
                f"within max_model_len={self.max_model_len}"
            )
        return self._encode_leftpad(full_prompts, limits, _LEN_BUCKETS)

    # --------------------------------------------------------- prefix caching

    def _prefix_len(self, prefix: str) -> int:
        n = self._prefix_lens_memo.get(prefix)
        if n is None:
            n = len(self.tokenizer.encode(prefix))
            self._prefix_lens_memo[prefix] = n
        return n

    def _prune_prefix_memo(self, cap: int = 512) -> None:
        if len(self._prefix_lens_memo) <= cap:
            return
        live = set()
        for p, _b in self._prefix_cache:
            live.add(p)
            if "\x1e" in p:
                live.add(p.split("\x1e", 1)[0])
        self._prefix_lens_memo = {
            p: n for p, n in self._prefix_lens_memo.items() if p in live
        }

    def _new_cache(self, batch: int, length: int, seq_split: bool = False):
        """A zero cache; ``seq_split``: a batch's decode cache, this rank's
        slice of the sequence under ``sp`` (prefix entries stay whole on
        every rank, so any batch cache can take them)."""
        return init_kv_cache(self.spec, batch, length, self.kv_dtype, self.device,
                             quantized=self.kv_quantized, seq_split=seq_split)

    def _sp_align(self, S: int) -> int:
        """Cache length aligned to ``sp`` (the slices must be equal)."""
        return S + (-S) % self._sp

    def _store_entry(self, key, entry) -> None:
        entry["bytes"] = entry["kv"].nbytes()
        self._prefix_bytes += entry["bytes"]
        self._prefix_cache[key] = entry
        self._prefix_active.add(key)

    def _get_prefix_entry(self, prefix: str, limit: int,
                          bucket: int) -> Optional[Dict[str, Any]]:
        """Prefill (once) and cache the KV of a static prompt prefix at the
        given bucket; ``None`` when the prefix cannot fit (the caller falls
        back to full-prompt prefill).  Same reuse/LRU rules as the JAX
        engine."""
        key = (prefix, bucket)
        entry = self._prefix_cache.get(key)
        if entry is None:
            for (p2, b2), e2 in self._prefix_cache.items():
                if p2 == prefix and bucket < b2 <= min(limit, 2 * bucket):
                    key, entry = (p2, b2), e2
                    break
        if entry is not None:
            self._prefix_cache.move_to_end(key)
            self._prefix_active.add(key)
            return entry
        toks = self.tokenizer.encode(prefix)
        if not toks or len(toks) > limit - 64:
            return None
        Pb = bucket
        if Pb > limit or len(toks) > Pb:
            return None
        tokens = np.full((1, Pb), self.tokenizer.pad_id, dtype=np.int32)
        valid = np.zeros((1, Pb), dtype=bool)
        tokens[0, Pb - len(toks):] = toks
        valid[0, Pb - len(toks):] = True
        cache = self._new_cache(1, Pb)
        _, kv = self._prefill_possibly_chunked(tokens, valid, Pb, cache)
        obs_counters.inc("engine.prefill.positions_padded", Pb)
        obs_counters.inc("engine.prefill.positions_real", len(toks))
        entry = {
            "kv": kv, "valid": valid[0], "len": len(toks), "bucket": Pb,
            "toks": np.asarray(toks, dtype=np.int32),
        }
        self._store_entry(key, entry)
        # A larger entry supersedes smaller-bucket duplicates.
        for k2 in [
            k for k in self._prefix_cache
            if k[0] == prefix and k[1] < Pb and k not in self._prefix_active
        ]:
            self._prefix_bytes -= self._prefix_cache.pop(k2)["bytes"]
        self._evict_prefix_over_budget()
        return entry

    def _assemble_cache(self, entries: List[Dict[str, Any]], gid: np.ndarray,
                        tail: int, seq_split: bool = False):
        """Batch cache ``[B, P + tail]`` whose slots ``[0, Pb)`` of row ``i``
        hold entry ``gid[i]``'s prefix KV (zero past each entry's bucket
        and in the tail; int8 scales one there) — one copy per distinct
        entry, all layers at once, in either cache layout.  An sp-split
        cache (``seq_split``) takes the entry slots its slice holds."""
        P = max(e["bucket"] for e in entries)
        cache = self._new_cache(len(gid), P + tail, seq_split)
        lo = cache.seq0 or 0
        sd = cache.seq_dim
        for u, e in enumerate(entries):
            n = min(e["bucket"], lo + cache.buf.shape[sd]) - lo
            if n <= 0:
                continue
            rows = torch.as_tensor(np.nonzero(gid == u)[0], device=self.device)
            src = e["kv"]
            cache.buf.narrow(sd, 0, n)[:, :, rows] = src.buf.narrow(sd, lo, n)
            if cache.quantized:
                cache.scales.narrow(sd, 0, n)[:, :, rows] = src.scales.narrow(sd, lo, n)
        return cache

    def _get_core_entry(self, prefix: str, core: str,
                        limit: int) -> Optional[Dict[str, Any]]:
        """Two-level prefix entry: the system ``prefix`` KV extended by a
        shared per-round ``core`` (vote-phase proposals + history),
        cached under a composite key."""
        composite = prefix + "\x1e" + core
        for (p2, b2), e2 in self._prefix_cache.items():
            if p2 == composite and b2 <= limit:
                self._prefix_cache.move_to_end((p2, b2))
                self._prefix_active.add((p2, b2))
                return e2
        core_toks = self.tokenizer.encode(core)
        if not core_toks:
            return None
        Cb = next((b for b in self._suffix_buckets if b >= len(core_toks)),
                  len(core_toks))
        p1_len = self._prefix_len(prefix)
        p1_limit = limit - 64 - Cb
        P1_rung = next(
            (b for b in _PREFIX_BUCKETS if b >= p1_len and b <= p1_limit),
            p1_limit if 0 < p1_len <= p1_limit else None,
        )
        if P1_rung is None or p1_len == 0:
            return None
        e1 = self._get_prefix_entry(prefix, limit, P1_rung)
        if e1 is None:
            return None
        P1b = e1["bucket"]
        Pb = P1b + Cb
        if Pb >= limit - 64 + 1:
            return None
        cache = self._assemble_cache([e1], np.zeros(1, np.int32), tail=Cb)
        tokens = np.full((1, Cb), self.tokenizer.pad_id, dtype=np.int32)
        cvalid = np.zeros((1, Cb), dtype=bool)
        tokens[0, Cb - len(core_toks):] = core_toks
        cvalid[0, Cb - len(core_toks):] = True
        pv = np.zeros((1, P1b), dtype=bool)
        pv[0] = e1["valid"]
        _, kv = self._prefill_possibly_chunked(
            tokens, cvalid, Cb, cache,
            prefix_valid=pv, prefix_lens=np.asarray([e1["len"]], np.int32),
        )
        obs_counters.inc("engine.prefill.positions_padded", Cb)
        obs_counters.inc("engine.prefill.positions_real", len(core_toks))
        entry = {
            "kv": kv,
            "valid": np.concatenate([pv[0], cvalid[0]]),
            "len": e1["len"] + len(core_toks),
            "bucket": Pb,
            "toks": np.concatenate([e1["toks"], np.asarray(core_toks, dtype=np.int32)]),
        }
        self._store_entry((composite, Pb), entry)
        self._evict_prefix_over_budget()
        return entry

    def _evict_prefix_over_budget(self) -> None:
        """LRU eviction by bytes — never a key of the batch being
        assembled; warns once when the active set alone is over budget."""
        evictable = [k for k in self._prefix_cache if k not in self._prefix_active]
        while self._prefix_bytes > self._prefix_budget and evictable:
            self._prefix_bytes -= self._prefix_cache.pop(evictable.pop(0))["bytes"]
        # Both entry creators end here: re-charging the engine's prefix
        # key with the post-eviction total keeps the ledger exact.
        obs_ledger.charge("prefix_cache", id(self), self._prefix_bytes)
        if self._prefix_bytes > self._prefix_budget and not self._prefix_over_budget_warned:
            warnings.warn(
                f"prefix-KV working set ({self._prefix_bytes / 1e9:.1f} GB) "
                f"exceeds its budget ({self._prefix_budget / 1e9:.1f} GB); "
                "prefix caching will hold it anyway for this batch",
                stacklevel=2,
            )
            self._prefix_over_budget_warned = True

    def _core_seam_safe(self, core_text: str, tail_text: str) -> bool:
        enc = self.tokenizer.encode
        return enc(core_text) + enc(tail_text) == enc(core_text + tail_text)

    def _prepare_prefixed_batch(self, parts, budgets: List[int],
                                decode_slots: Optional[int] = None):
        """Assemble a batch whose cache slots ``[0, P)`` hold each row's
        prefix KV (from the prefix cache) and whose suffix is left-padded
        into ``[P, P+Ls)``; each row's prefix tokens ride along for the
        speculative drafter's history.  ``None`` when any prefix cannot be
        cached."""
        limit = self.max_model_len - max(budgets) - 1
        rows = []
        seam_memo: Dict[Tuple[str, str], bool] = {}
        for p, c, t in parts:
            if c:
                ok = seam_memo.get((c, t))
                if ok is None:
                    ok = self._core_seam_safe(c, t)
                    seam_memo[(c, t)] = ok
                rows.append((p, c, t) if ok else (p, "", c + t))
            else:
                rows.append((p, "", t))
        plain_prefixes = list(dict.fromkeys(p for p, c, _ in rows if not c))
        P_rung = None
        if plain_prefixes:
            max_len = max(self._prefix_len(p) for p in plain_prefixes)
            if max_len == 0 or max_len > limit - 64:
                return None
            P_rung = next(
                (b for b in _PREFIX_BUCKETS if b >= max_len and b <= limit),
                limit - 64,
            )
        entries: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self._prefix_active = set()
        try:
            for p, c, _ in rows:
                if (p, c) in entries:
                    continue
                e = (
                    self._get_core_entry(p, c, limit)
                    if c
                    else self._get_prefix_entry(p, limit, P_rung)
                )
                if e is None:
                    return None
                entries[(p, c)] = e
        finally:
            self._prefix_active = set()
        self._prune_prefix_memo()
        uniq = list(entries)
        max_new = max(budgets)
        P = max(e["bucket"] for e in entries.values())
        limits_s = [self.max_model_len - b - 1 - P for b in budgets]
        if min(limits_s) < 1:
            return None
        tokens, valid, Ls = self._encode_leftpad(
            [t for _, _, t in rows], limits_s, self._suffix_buckets
        )
        B = len(rows)
        gid = np.array([uniq.index((p, c)) for p, c, _ in rows], dtype=np.int32)
        tail = Ls + (decode_slots if decode_slots is not None else max_new + 1)
        tail = self._sp_align(P + tail) - P
        cache = self._assemble_cache([entries[k] for k in uniq], gid, tail, seq_split=True)
        prefix_valid = np.zeros((B, P), dtype=bool)
        prefix_lens = np.zeros((B,), dtype=np.int32)
        prefix_toks = []
        for i, (p, c, _) in enumerate(rows):
            e = entries[(p, c)]
            prefix_valid[i, : e["bucket"]] = e["valid"]
            prefix_lens[i] = e["len"]
            prefix_toks.append(e["toks"])
        return (tokens, valid, Ls, cache, prefix_valid, prefix_lens, prefix_toks,
                P, P + tail)

    # ----------------------------------------------------------- paged assembly

    @staticmethod
    def _rightpad_tokens(token_lists, limits: List[int],
                         bucket_ladder: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray, int]:
        """RIGHT-pad per-row token lists (already truncated to their row
        limits) into a bucketed [B, L] batch — the paged counterpart of
        :meth:`_encode_leftpad`: tokens left-ALIGNED so full real-token
        blocks can be shared (see ``transformer.prefill_paged``).  Same
        ladder semantics."""
        max_len = max((len(t) for t in token_lists), default=0)
        max_limit = max(limits)
        buckets = list(bucket_ladder)
        while buckets[-1] < max_limit:
            buckets.append(buckets[-1] * 2)
        L = next((b for b in buckets if b >= max_len), max_limit)
        L = max(min(L, max_limit), max_len, 1)
        B = len(token_lists)
        tokens = np.zeros((B, L), dtype=np.int32)
        valid = np.zeros((B, L), dtype=bool)
        for i, toks in enumerate(token_lists):
            tokens[i, : len(toks)] = toks
            valid[i, : len(toks)] = True
        return tokens, valid, L

    def _paged_tokens(self, text: str) -> np.ndarray:
        """Tokenize, memoized (radix keys are token arrays, and every
        batch re-derives its entries); bounded like the length memo."""
        toks = self._paged_toks_memo.get(text)
        if toks is None:
            toks = np.asarray(self.tokenizer.encode(text), dtype=np.int32)
            self._paged_toks_memo[text] = toks
            if len(self._paged_toks_memo) > 512:
                self._paged_toks_memo = dict(list(self._paged_toks_memo.items())[-256:])
        return toks

    def _get_paged_entry(self, text: str, limit: int) -> Optional[Dict[str, Any]]:
        """Resolve a cachable prompt prefix against the radix index:
        longest full-block match, then ONE B=1 prefill of the unmatched
        remainder (up to the last full block boundary) into fresh blocks
        grafted onto the tree — the paged successor of
        :meth:`_get_prefix_entry`/:meth:`_get_core_entry`.  The sub-block
        leftover is returned for the caller's per-row suffix.  None when
        the prefix cannot fit the prompt window."""
        mgr = self._paged
        bs = mgr.block_size
        toks = self._paged_tokens(text)
        if toks.size == 0 or len(toks) > limit - 64:
            return None
        path, blocks = mgr.lookup(toks)
        mgr.pin(path)
        matched = len(blocks) * bs
        full_end = (len(toks) // bs) * bs
        if full_end > matched:
            Lr = full_end - matched
            # Bucket the build chunk for stable shapes; the pad tail lands
            # in scratch blocks freed right after the insert.
            Lr_pad = next((b for b in self._suffix_buckets if b >= Lr), Lr)
            Lr_pad = -(-Lr_pad // bs) * bs
            Pm_pad = 0
            if matched:
                Pm_rung = next((b for b in _PREFIX_BUCKETS if b >= matched), matched)
                Pm_pad = -(-Pm_rung // bs) * bs
            n_real = Lr // bs
            new_ids = mgr.alloc(Lr_pad // bs)
            # Provisional ownership: freed by the call's finally unless the
            # insert below grafts them into the tree.
            self._paged_call_private.extend(new_ids)
            tbl = np.zeros((1, Pm_pad // bs + Lr_pad // bs), dtype=np.int32)
            tbl[0, : len(blocks)] = blocks
            tbl[0, Pm_pad // bs:] = new_ids
            tokens = np.zeros((1, Lr_pad), dtype=np.int32)
            tokens[0, :Lr] = toks[matched:full_end]
            valid = np.zeros((1, Lr_pad), dtype=bool)
            valid[0, :Lr] = True
            pv = np.zeros((1, Pm_pad), dtype=bool)
            pv[0, :matched] = True
            cache = mgr.entries(tbl)
            self._paged_dirty = True
            self._prefill_paged_possibly_chunked(tokens, valid, Lr_pad, cache, pv,
                                                 np.asarray([matched], np.int32))
            self._paged_dirty = False
            obs_counters.inc("engine.prefill.positions_padded", Lr_pad)
            obs_counters.inc("engine.prefill.positions_real", Lr)
            grafted = mgr.insert(path, toks, matched, new_ids[:n_real])
            kept = {node.block for node in grafted}
            # Everything not grafted is dead the moment insert returns (the
            # scratch pad tail and any duplicate-content blocks): free it
            # now, so peak pool demand stays what admission accounts for.
            dead = set(new_ids) - kept
            mgr.free(dead)
            self._paged_call_private = [
                i for i in self._paged_call_private if i not in kept and i not in dead
            ]
            path = path + grafted
            blocks = [node.block for node in path]
        return {
            "blocks": blocks,
            "len": full_end,
            "toks": toks[:full_end],
            "leftover": toks[full_end:],
        }

    def _warn_prefix_fallback(self, why: str) -> None:
        self.prefix_fallbacks += 1
        if not self._prefix_fallback_warned:
            warnings.warn(
                f"radix prefix sharing disengaged for this batch ({why}) — the "
                "whole prompt prefills into private blocks; further fallbacks "
                "are counted in engine.prefix_fallbacks",
                stacklevel=3,
            )
            self._prefix_fallback_warned = True

    def _prepare_paged_batch(self, parts, budgets: List[int], decode_slots: int,
                             dp_rows: Optional[slice] = None):
        """Assemble a batch over the block pool: per-row block tables of
        radix-shared prefix blocks (padded with the null block to a
        bucketed prefix region) plus freshly allocated private blocks for
        the suffix window and the decode tail.  Radix-cached prefixes
        when the batch qualifies (the dense prefix cache's conditions),
        else the whole prompt as suffix over private blocks — a paged
        engine never falls back to dense slabs.  ``dp_rows``: this ``dp``
        rank's rows, whose arrays and tables are returned after the whole
        batch was assembled (every rank's allocator and radix tree take
        the same calls)."""
        mgr = self._paged
        bs = mgr.block_size
        B = len(parts)
        limits = [self.max_model_len - b - 1 for b in budgets]
        if min(limits) < 1:
            raise BudgetError(
                f"max_tokens={max(budgets)} leaves no room for a prompt "
                f"within max_model_len={self.max_model_len}"
            )
        limit = self.max_model_len - max(budgets) - 1
        cacheable = self.prefix_caching and self._prefix_safe and all(p for p, _, _ in parts)
        rows = None
        entries: Optional[Dict[Tuple[str, str], Dict[str, Any]]] = None
        if cacheable:
            # Seam safety decides per ROW whether its core is usable, as
            # in _prepare_prefixed_batch.
            rows = []
            seam_memo: Dict[Tuple[str, str], bool] = {}
            for p, c, t in parts:
                if c:
                    ok = seam_memo.get((c, t))
                    if ok is None:
                        ok = self._core_seam_safe(c, t)
                        seam_memo[(c, t)] = ok
                    rows.append((p, c, t) if ok else (p, "", c + t))
                else:
                    rows.append((p, "", t))
            entries = {}
            for p, c, _ in rows:
                if (p, c) in entries:
                    continue
                e = self._get_paged_entry(p + c, limit)
                if e is None:
                    entries = None
                    break
                entries[(p, c)] = e
            if entries is None:
                cacheable = False
                self._warn_prefix_fallback("prefix too long for the prompt window")
        if cacheable:
            res = [entries[(p, c)] for p, c, _ in rows]
            suffix_toks = [list(e["leftover"]) + list(self._paged_tokens(t))
                           for e, (_, _, t) in zip(res, rows)]
            ladder = self._suffix_buckets
        else:
            res = [None] * B
            suffix_toks = [list(self._paged_tokens(p + c + t)) for p, c, t in parts]
            ladder = _LEN_BUCKETS
        max_res = max(e["len"] if e else 0 for e in res)
        P = 0
        if max_res:
            P_rung = next((b for b in _PREFIX_BUCKETS if b >= max_res and b <= limit),
                          max(max_res, limit - 64))
            P = -(-P_rung // bs) * bs
        limits_s = [lim - P for lim in limits]
        if min(limits_s) < 1:
            # A mixed-budget row cannot fit any suffix past the shared
            # prefix region: serve the batch uncached (still paged).
            self._warn_prefix_fallback("a row's token budget leaves no suffix room past "
                                       "the shared prefix region")
            res = [None] * B
            suffix_toks = [list(self._paged_tokens(p + c + t)) for p, c, t in parts]
            ladder = _LEN_BUCKETS
            P = 0
            limits_s = limits
        suffix_toks = [t[-lim:] for t, lim in zip(suffix_toks, limits_s)]
        tokens, valid, Ls = self._rightpad_tokens(suffix_toks, limits_s, ladder)
        S = P + Ls + decode_slots
        S += (-S) % bs
        nblk = S // bs
        n_priv = (S - P) // bs
        priv = mgr.alloc(B * n_priv)
        self._paged_call_private.extend(priv)
        tbl = np.zeros((B, nblk), dtype=np.int32)
        prefix_valid = np.zeros((B, P), dtype=bool)
        prefix_lens = np.zeros((B,), dtype=np.int32)
        prefix_toks = []
        for i in range(B):
            e = res[i]
            if e is not None:
                tbl[i, : len(e["blocks"])] = e["blocks"]
                prefix_valid[i, : e["len"]] = True
                prefix_lens[i] = e["len"]
                prefix_toks.append(e["toks"])
            else:
                prefix_toks.append(np.zeros(0, dtype=np.int32))
            tbl[i, P // bs:] = priv[i * n_priv:(i + 1) * n_priv]
        if dp_rows is not None:
            tbl, tokens, valid, prefix_valid, prefix_lens, prefix_toks = (
                a[dp_rows] for a in (tbl, tokens, valid, prefix_valid, prefix_lens, prefix_toks))
        cache = mgr.entries(tbl, dp_split=dp_rows is not None)
        return (tokens, valid, Ls, cache, prefix_valid, prefix_lens, prefix_toks, P, S)

    # -------------------------------------------------------------- prefill

    def _prefill_possibly_chunked(self, tokens, valid, L: int, cache,
                                  prefix_valid=None, prefix_lens=None):
        """Prefill ``tokens`` (optionally against a cached prefix in slots
        ``[0, P)``), in ``prefill_chunk``-sized slices when configured."""
        C = self.prefill_chunk
        has_prefix = prefix_valid is not None
        P = prefix_valid.shape[1] if has_prefix else 0
        if not C or L <= C:
            if has_prefix and cache.seq0 is not None:
                # The suffix is ONE chunk against the cached prefix, written
                # into the sp-split cache and attending all of it slice by
                # slice (prefill_chunk_at's ring branch, as the JAX engine).
                return prefill_chunk_at(
                    self.params, self.spec, self._dev(tokens, torch.long),
                    self._dev(valid), cache, self._dev(prefix_valid),
                    self._dev(prefix_lens, torch.int32), P,
                )
            if has_prefix:
                return prefill_with_prefix(
                    self.params, self.spec, self._dev(tokens, torch.long),
                    self._dev(valid), cache, self._dev(prefix_valid),
                    self._dev(prefix_lens, torch.int32),
                )
            if self._sp > 1:
                if L % self._sp == 0:
                    return prefill_sp(self.params, self.spec, self._dev(tokens, torch.long),
                                      self._dev(valid), cache)
                # An off-ladder window: every rank prefills the whole prompt.
                self._note_sp_bypass(f"prompt window L={L} not divisible by sp={self._sp}")
            return prefill(self.params, self.spec, self._dev(tokens, torch.long),
                           self._dev(valid), cache)
        B = tokens.shape[0]
        base_lens = (np.asarray(prefix_lens, dtype=np.int64) if has_prefix
                     else np.zeros(B, np.int64))
        first_logits = None
        for start in range(0, L, C):
            Ct = min(C, L - start)
            H = P + L - Ct
            hist = np.zeros((B, H), dtype=bool)
            if has_prefix:
                hist[:, :P] = prefix_valid
            hist[:, P:P + start] = valid[:, :start]
            pos_off = base_lens + valid[:, :start].sum(axis=1)
            first_logits, cache = prefill_chunk_at(
                self.params, self.spec,
                self._dev(tokens[:, start:start + Ct], torch.long),
                self._dev(valid[:, start:start + Ct]), cache, self._dev(hist),
                self._dev(pos_off.astype(np.int32)), P + start,
            )
        return first_logits, cache

    def _note_sp_bypass(self, reason: str) -> None:
        """Count (and warn once about) a prefill that could not go round
        the ``sp`` ring: every rank computes it whole instead."""
        self.sp_bypasses += 1
        obs_counters.inc("engine.sp_bypasses")
        if self.sp_bypasses == 1:
            warnings.warn(f"sequence-parallel prefill bypassed: {reason}; further "
                          "bypasses are counted in engine.sp_bypasses", stacklevel=3)

    def _dp_rows(self, B: int) -> slice:
        """This rank's rows of a batch padded to a multiple of ``dp``."""
        n = B // self._dp
        return slice(self.spec.par.dp_rank * n, (self.spec.par.dp_rank + 1) * n)

    def _dp_mult(self, cap) -> int:
        """The dp padding multiple a row cap allows: below dp, the batch
        runs whole on every dp rank (counted and warned once)."""
        if self._dp == 1 or not cap or self._dp <= cap:
            return self._dp
        self.dp_bypasses += 1
        obs_counters.inc("engine.dp_bypasses")
        if self.dp_bypasses == 1:
            warnings.warn(f"data-parallel batch split bypassed: row cap {cap} below "
                          f"dp={self._dp}; further bypasses are counted in "
                          "engine.dp_bypasses", stacklevel=3)
        return 1

    def _prefill_paged_possibly_chunked(self, tokens, valid, Ls: int, cache,
                                        prefix_valid, prefix_lens):
        """Paged prefill — one pass, or ``prefill_chunk``-sized slices
        through the block pool when configured and the window exceeds the
        chunk.  Chunk ``k`` writes logical slots ``[P + kC, P + kC + C)``
        and attends the radix prefix plus every earlier chunk through a
        fixed block-aligned ``[B, H]`` history mask; the per-row
        last-valid logits thread through a carry (chunks are
        right-padded).  Serves batch prefills and the radix entry builds."""
        C = self.prefill_chunk
        if not C or Ls <= C:
            return prefill_paged(
                self.params, self.spec, self._dev(tokens, torch.long), self._dev(valid),
                cache, self._dev(prefix_valid), self._dev(prefix_lens, torch.int32),
            )
        tokens = np.asarray(tokens)
        valid = np.asarray(valid)
        prefix_valid = np.asarray(prefix_valid)
        bs = self._paged.block_size
        if Ls % bs:
            # The history window H = P + Ls - C must be block-aligned (C
            # already is): align the window up with masked pad columns,
            # which lie inside the table's block-rounded coverage.
            pad = (-Ls) % bs
            tokens = np.pad(tokens, ((0, 0), (0, pad)))
            valid = np.pad(valid, ((0, 0), (0, pad)))
            Ls += pad
        B = tokens.shape[0]
        P = prefix_valid.shape[1]
        base_lens = np.asarray(prefix_lens, dtype=np.int64)
        logits = torch.zeros((B, self.spec.vocab_size), dtype=torch.float32,
                             device=self.device)
        for start in range(0, Ls, C):
            Ct = min(C, Ls - start)
            H = P + Ls - Ct
            hist = np.zeros((B, H), dtype=bool)
            hist[:, :P] = prefix_valid
            hist[:, P:P + start] = valid[:, :start]
            pos_off = base_lens + valid[:, :start].sum(axis=1)
            logits, cache = prefill_paged_chunk_at(
                self.params, self.spec,
                self._dev(tokens[:, start:start + Ct], torch.long),
                self._dev(valid[:, start:start + Ct]), cache, self._dev(hist),
                self._dev(pos_off.astype(np.int32)), P + start, logits,
            )
        return logits, cache

    # ---------------------------------------------------------- decode loop

    def _decode_loop(self, cache, first_logits, valid_mask, prompt_lens, L: int,
                     batch: GuidedBatch, temps, budgets, max_new: int,
                     top_p: float, entry: str = "decode_loop", poll: bool = True):
        """The guided token loop (``_decode_loop_fn``'s semantics).
        Returns ``(out [B, max_new] int32, steps)`` on the device;
        ``entry`` names the loop for the host-sync audit and the launch
        census.  ``temps``/``budgets``: per-row lists, or tensors already
        on the device.  ``poll=False`` (the fused round) runs all
        ``max_new - 1`` steps with no "all done" poll, so the loop reads
        nothing on the host; ``steps`` counts the same steps either way."""
        spec = self.spec
        eos = self.tokenizer.eos_id
        sampler = make_fused_sampler(eos, top_p)
        row_temp = temps if torch.is_tensor(temps) else self._dev(np.asarray(temps, np.float32))
        row_budget = (budgets if torch.is_tensor(budgets)
                      else self._dev(np.asarray(budgets, np.int32)))
        census = obs_hlo.step_census(entry, self.device)

        def sample(logits, states, emitted):
            return sampler(logits, states, self._gen, emitted, batch.tables,
                           batch.accepting, batch.min_budget, batch.dfa_ids,
                           row_temp, row_budget)

        tok0, states = sample(first_logits, batch.init_states, 0)
        B = first_logits.shape[0]
        out = torch.full((B, max_new), eos, dtype=torch.int32, device=self.device)
        out[:, 0] = tok0
        done = tok0 == eos
        cur = tok0
        eos_t = torch.full_like(tok0, eos)
        steps = torch.zeros((), dtype=torch.int32, device=self.device)
        for i in range(max_new - 1):
            # Position max_new-1 is the last output slot, written by step
            # max_new-2.  Steps taken after every row finished only write
            # EOS over EOS; `steps` counts the ones the JAX loop runs.
            if poll and i % _DONE_CHECK == 0 and self._done_poll(done, entry):
                break
            if census is not None:
                census.begin(i)
            steps += (~done.all()).to(torch.int32)
            valid_mask[:, L + i] = True
            logits, cache = decode_step(
                self.params, spec, torch.where(done, eos_t, cur).long(), L + i,
                prompt_lens + i, cache, valid_mask,
            )
            tok, states = sample(logits, states, i + 1)
            tok = torch.where(done, eos_t, tok)
            out[:, i + 1] = tok
            done = done | (tok == eos)
            cur = torch.where(done, cur, tok)
            if census is not None:
                census.end(i)
        if census is not None:
            census.close()
        return out, steps

    def _ff_decode_loop(self, cache, first_logits, valid_mask, prompt_lens, L: int,
                        batch: GuidedBatch, temps, budgets, max_new: int, top_p: float,
                        entry: str = "ff_decode_loop"):
        """The forced-chain fast-forward loop (the JAX engine's
        ``_build_ff_decode_loop``): every iteration samples ONE token and
        rides its DFA-forced continuation (up to FF_CHUNK-1 skeleton
        tokens) through the same weight pass (``decode_chunk``).  The
        cache write position advances by 1 + the iteration's widest row
        chain (compacted; shorter chains leave masked gaps inside the
        window) and stays a device tensor, written with ``index_copy_``.
        Greedy output is token-identical to the plain loop.  Returns
        ``(out [B, max_new] int32, steps)`` on the device."""
        K = FF_CHUNK
        spec = self.spec
        eos = self.tokenizer.eos_id
        dev = self.device
        sampler = make_fused_sampler(eos, top_p)
        row_temp = self._dev(np.asarray(temps, np.float32))
        row_budget = self._dev(np.asarray(budgets, np.int32))
        census = obs_hlo.step_census(entry, dev)
        B = first_logits.shape[0]
        tail_slots = _ff_decode_slots(max_new)
        dfa = batch.dfa_ids.long()
        jr = torch.arange(K, device=dev)[None, :]
        # One spare column: the target of every dropped write.
        out = torch.full((B, max_new + K), eos, dtype=torch.int32, device=dev)
        wp = torch.full((), L, dtype=torch.int64, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        emitted = torch.zeros((B,), dtype=torch.int32, device=dev)
        states = batch.init_states.to(torch.int32)
        eos_t = torch.full((B,), eos, dtype=torch.int32, device=dev)
        zero = torch.zeros((B,), dtype=torch.int32, device=dev)
        steps = torch.zeros((), dtype=torch.int32, device=dev)
        logits = first_logits
        for i in range(max_new):
            if i % _DONE_CHECK == 0 and self._done_poll(done, entry):
                break
            if census is not None:
                census.begin(i)
            steps += (~done.all()).to(torch.int32)
            tok, ns = sampler(logits, states, self._gen, emitted, batch.tables,
                              batch.accepting, batch.min_budget, batch.dfa_ids,
                              row_temp, row_budget)
            tok = torch.where(done, eos_t, tok)
            finished = tok == eos
            cns = ns.clamp(min=0).long()
            # Capacity guard: chains switch off once the compacted write
            # position could no longer fit the worst-case remainder (each
            # later iteration advancing one slot, every write needing a K
            # window).  A forced state has one legal token, so the sampler
            # then emits the chain one token per iteration: same output.
            room_ok = (wp - L) <= tail_slots - 2 * K - (max_new - i - 1)
            cl = torch.where(done | finished | ~room_ok, zero, batch.chain_len[dfa, cns])
            chunk = torch.cat([tok[:, None].long(), batch.chain_tok[dfa, cns].long()], dim=1)
            chunk_valid = (jr == 0) | (jr - 1 < cl[:, None])
            write_idx = torch.where(chunk_valid & ~done[:, None], emitted[:, None] + jr,
                                    max_new + K - 1)
            out.scatter_(1, write_idx, chunk.to(torch.int32))
            positions = (prompt_lens + emitted)[:, None] + jr
            logits, cache = decode_chunk(self.params, spec, chunk, chunk_valid, wp,
                                         positions, cache, valid_mask)
            valid_mask.index_copy_(1, wp + jr[0], chunk_valid)
            emitted = torch.where(done, emitted, emitted + 1 + cl)
            # Compacted advance: the next window starts right after this
            # iteration's widest row.
            wp = wp + 1 + torch.where(done, zero, cl).max()
            next_states = torch.where(room_ok, batch.chain_next[dfa, cns], cns.to(torch.int32))
            states = torch.where(done, states, next_states.to(torch.int32))
            states = torch.where(finished, torch.full_like(states, -1), states)
            done = done | finished
            if census is not None:
                census.end(i)
        if census is not None:
            census.close()
        return out[:, :max_new], steps

    def _spec_decode_loop(self, cache, first_logits, valid_mask, prompt_lens, L: int,
                          batch: GuidedBatch, temps, budgets, max_new: int, top_p: float,
                          hist: np.ndarray, entry: str = "spec_decode_loop"):
        """The speculative loop (``engine/speculative.spec_decode_loop``)
        over this batch.  Returns ``(out, steps, drafted [B], accepted
        [B])`` on the device."""
        eos = self.tokenizer.eos_id
        return spec_decode_loop(
            self.params, self.spec, cache, first_logits, valid_mask, prompt_lens, L, batch,
            self._dev(np.asarray(temps, np.float32)), self._dev(np.asarray(budgets, np.int32)),
            self._dev(hist), self._gen, sampler=make_fused_sampler(eos, top_p), eos_id=eos,
            top_p=top_p, max_new=max_new, k=self.spec_k, n=self.spec_ngram,
            done_check=_DONE_CHECK, all_done=lambda done: self._done_poll(done, entry),
            census=obs_hlo.step_census(entry, self.device),
        )

    def _decode_batch(self, parts, batch, real_B, temps, budgets, top_p,
                      free: bool = False, dp_rows: Optional[slice] = None) -> List[str]:
        """:meth:`_decode_batch_impl`, and the call's ``finally``: credit
        the call's KV ledger accounts; for a paged engine, free the call's
        private blocks and unpin its radix paths — or, after a failure
        while blocks were being written, invalidate the pool (its contents
        are undefined) — then charge the radix-resident blocks to the
        prefix account and publish the pool snapshot
        (``runtime.metrics.publish_kv_pool``)."""
        try:
            return self._decode_batch_impl(parts, batch, real_B, temps, budgets, top_p,
                                           free=free, dp_rows=dp_rows)
        finally:
            if self._paged is not None:
                if self._paged_dirty:
                    self._paged_dirty = False
                    self._paged_call_private = []
                    self._paged.invalidate()
                else:
                    self._paged.free(self._paged_call_private)
                    self._paged_call_private = []
                    self._paged.unpin_all()
                pool = self.kv_pool_stats()
                obs_ledger.charge("prefix_cache", id(self),
                                  pool["blocks_resident"] * self._paged.block_bytes_dev)
                _metrics.publish_kv_pool(pool)
            obs_ledger.credit("kv_cache", id(self))
            obs_ledger.credit("spec_slots", id(self))
            if self._mem_limit is not None:
                # Real allocator present: publish the drift gauge (ledger
                # vs memory_allocated) each call — the leak alarm.
                obs_ledger.reconcile()

    def _decode_batch_impl(self, parts, batch, real_B, temps, budgets, top_p,
                           free: bool = False, dp_rows: Optional[slice] = None) -> List[str]:
        """Prefill + guided decode for a batch-padded list of
        ``(prefix, core, suffix)`` prompt parts (the JAX engine's
        ``_decode_batch_impl``): over the block pool for a paged engine,
        else over a dense cache with the prefix cache.  Speculative
        decoding applies to both the guided and the ``free`` path and
        supersedes fast-forward; fast-forward skips the free path, whose
        permissive automaton has no forced chains.  Traced as the
        ``engine.prefill`` and ``engine.decode`` spans; the batch's KV
        bytes are charged to the ledger until the call ends.  ``dp_rows``:
        this rank's rows of the padded batch (``parts``, ``temps`` and
        ``budgets`` are the whole batch's, ``batch`` the rank's rows), whose
        outputs are gathered over ``dp`` after the loop (``real_B`` counts
        the whole batch's real rows).  The decode window is the whole
        batch's, so every dp rank runs one shape, as one device does; a
        paged engine assembles the whole batch on every rank and keeps its
        rows (``PagedCache.dp_split``)."""
        max_new = max(budgets)
        all_parts, all_budgets = parts, budgets
        if dp_rows is not None:
            parts, temps, budgets = parts[dp_rows], temps[dp_rows], budgets[dp_rows]
            self.dp_batches += 1
        B = len(parts)
        use_spec = self.spec_decode
        use_ff = not use_spec and self.fast_forward and not free
        if use_spec:
            decode_slots = spec_decode_slots(max_new, self.spec_k)
        elif use_ff:
            decode_slots = _ff_decode_slots(max_new)
        else:
            decode_slots = max_new + 1
        self._check_kv_budget(len(all_parts), all_budgets, decode_slots)
        t0 = time.perf_counter()
        paged = self._paged is not None
        with obs_tracer.span("engine.prefill", args={"rows": B}):
            prepped = None
            if paged:
                (tokens, valid, Ls, cache, prefix_valid, prefix_lens, prefix_toks, P,
                 S) = self._prepare_paged_batch(all_parts, all_budgets, decode_slots, dp_rows)
                self._paged_dirty = True
                first_logits, cache = self._prefill_paged_possibly_chunked(
                    tokens, valid, Ls, cache, prefix_valid, prefix_lens)
                self._paged_dirty = False
                L = P + Ls
                valid_mask = np.zeros((B, S), dtype=bool)
                valid_mask[:, :P] = prefix_valid
                valid_mask[:, P:L] = valid
                prompt_lens = (prefix_lens + valid.sum(axis=1)).astype(np.int32)
                # Private blocks only (every row's: the pool takes them all
                # under dp): the radix-shared prefix is the prefix account's.
                kv_bytes = (len(all_parts) * ((S - P) // self._paged.block_size)
                            * self._paged.block_bytes_dev)
            elif self.prefix_caching and self._prefix_safe and all(p for p, _, _ in parts):
                prepped = self._prepare_prefixed_batch(parts, budgets, decode_slots)
                if prepped is None:
                    self.prefix_fallbacks += 1
                    if not self._prefix_fallback_warned:
                        warnings.warn(
                            "prefix caching disengaged for this batch (prefix too "
                            "long for the prompt window or unbucketable) — falling "
                            "back to full-prompt prefill; further fallbacks are "
                            "counted in engine.prefix_fallbacks",
                            stacklevel=2,
                        )
                        self._prefix_fallback_warned = True
            if not paged:
                prefix_toks = None
            if prepped is not None:
                (tokens, valid, Ls, cache, prefix_valid, prefix_lens, prefix_toks, P,
                 S) = prepped
                first_logits, cache = self._prefill_possibly_chunked(
                    tokens, valid, Ls, cache,
                    prefix_valid=prefix_valid, prefix_lens=prefix_lens,
                )
                L = P + Ls
                valid_mask = np.zeros((B, S), dtype=bool)
                valid_mask[:, :P] = prefix_valid
                valid_mask[:, P:L] = valid
                prompt_lens = (prefix_lens + valid.sum(axis=1)).astype(np.int32)
            elif not paged:
                full_prompts = [p + c + t for p, c, t in parts]
                tokens, valid, L = self._prepare_batch(full_prompts, budgets)
                S = self._sp_align(L + decode_slots)
                cache = self._new_cache(B, S, seq_split=True)
                first_logits, cache = self._prefill_possibly_chunked(tokens, valid, L, cache)
                valid_mask = np.zeros((B, S), dtype=bool)
                valid_mask[:, :L] = valid
                prompt_lens = valid.sum(axis=1).astype(np.int32)
            if not paged:
                kv_bytes = cache.nbytes()
            # The decode tail's over-allocation (speculative K+1 window,
            # fast-forward chains) is its own ledger account.
            spec_part = int(kv_bytes * max(0, decode_slots - (max_new + 1)) / S)
            obs_ledger.charge("kv_cache", id(self), kv_bytes - spec_part)
            obs_ledger.charge("spec_slots", id(self), spec_part)
            obs_counters.inc("engine.prefill.positions_padded",
                             B * (L if (prepped is None and not paged) else Ls))
            obs_counters.inc("engine.prefill.positions_real", int(valid.sum()))
            obs_hostsync.note("prefill_barrier", entry="prefill")
            with obs_hostsync.expected():
                self._sync()
        t1 = time.perf_counter()
        # The loop's name: the host-sync audit's attribution when tracing
        # is off, and the launch census's entry.
        loop_entry = ("paged_" if paged else "") + (
            "spec_decode_loop" if use_spec else "ff_decode_loop" if use_ff else "decode_loop")
        sampler_launches = sample_rows.launches
        with obs_tracer.span("engine.decode", args={"rows": B, "max_new": max_new}):
            # A paged loop writes decode KV into private pool blocks.
            self._paged_dirty = paged
            loop_args = (cache, first_logits, self._dev(valid_mask), self._dev(prompt_lens),
                         L, batch, temps, budgets, max_new, top_p)
            if use_spec:
                # Token history for the prompt-lookup drafter: row i's
                # prompt tokens (prefix entry tokens, then the suffix) at
                # [0, prompt_lens[i]), -1 elsewhere.
                hist = np.full((B, L + max_new), -1, dtype=np.int32)
                for i in range(B):
                    row = tokens[i][valid[i]]
                    if prefix_toks is not None:
                        row = np.concatenate([prefix_toks[i], row])
                    hist[i, : len(row)] = row
                with obs_tracer.span("engine.spec_verify",
                                     args={"rows": B, "k": self.spec_k, "ngram": self.spec_ngram}):
                    out, steps, drafted, accepted = self._spec_decode_loop(
                        *loop_args, hist, entry=loop_entry)
            elif use_ff:
                out, steps = self._ff_decode_loop(*loop_args, entry=loop_entry)
            else:
                out, steps = self._decode_loop(*loop_args, entry=loop_entry)
            self._paged_dirty = False
            if dp_rows is not None:
                out = all_gather(out, self.mesh, "dp", dim=0)
                steps = all_reduce(steps.clone(), self.mesh, "dp", op="max")
            out_np = self._read_back("decode_readback", loop_entry, out)
        steps = int(self._read_back("steps_readback", loop_entry, steps))
        sampler_launches = sample_rows.launches - sampler_launches
        if sampler_launches:
            # Sampler kernel launches, counted where they happen: the loop
            # goes on launching after every row is done, up to the next
            # done poll, so ``steps`` would undercount them.
            obs_counters.inc("engine.sampler.fused_calls", sampler_launches)
        if use_spec:
            # Draft acceptance over REAL rows only (padding rows repeat
            # row 0 and would inflate the rate).
            obs_hostsync.note("spec_readback", n=2, entry=loop_entry)
            with obs_hostsync.expected():
                spec_drafted = int(drafted[:real_B].sum())
                spec_accepted = int(accepted[:real_B].sum())
            self.spec_drafted += spec_drafted
            self.spec_accepted += spec_accepted
            if spec_drafted:
                obs_counters.inc("engine.spec.drafted", spec_drafted)
                obs_counters.inc("engine.spec.accepted", spec_accepted)
                obs_counters.inc("engine.spec.rejected", spec_drafted - spec_accepted)
        # Refresh LAST_HOSTSYNC once per generation call (no-op when the
        # auditor is off).
        obs_hostsync.publish()
        self.max_kv_cache_bytes = max(self.max_kv_cache_bytes, kv_bytes)
        is_eos = out_np == self.tokenizer.eos_id
        row_len = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), max_new)
        self.total_plain_steps += int(min(max_new - 1, row_len.max()))
        del cache, loop_args
        t2 = time.perf_counter()
        self.last_decode_steps = steps
        self.total_decode_steps += steps
        self.prefill_seconds += t1 - t0
        self.decode_seconds += t2 - t1
        if _TIMING:
            print(
                f"[engine] decode B={B} L={L} S={S} max_new={max_new} "
                f"loop={'spec' if use_spec else 'ff' if use_ff else 'plain'} "
                f"steps={steps} prefill={t1 - t0:.3f}s decode={t2 - t1:.3f}s "
                f"prefix={'hit' if (prepped is not None or (paged and P)) else 'miss'}",
                flush=True, file=sys.stderr,
            )
        texts = []
        for i in range(real_B):
            row = out_np[i]
            end = np.where(row == self.tokenizer.eos_id)[0]
            row = row[: end[0]] if end.size else row
            texts.append(self.tokenizer.decode(row.tolist()))
        return texts

    def _decode_padded(self, parts, batch, real_B, temps, budgets, top_p,
                       free: bool = False, dp_rows: Optional[slice] = None) -> List[str]:
        """:meth:`_decode_batch` of a padded batch, its padded size noted as
        a shape signature (``pad_batch``, obs/compile.py).  Nothing is
        compiled per shape here: the one-time costs of a new size (plan
        queries, workspace growth) are timed at their own seams in the
        kernel wrappers, and the first call of a new size is timed whole,
        as the JAX engine times a new signature's first dispatch."""
        obs_compile.note_shape("pad_batch", (len(parts),), names=("batch",))
        with obs_compile.time_block("pad_batch"):
            return self._decode_batch(parts, batch, real_B, temps, budgets, top_p,
                                      free=free, dp_rows=dp_rows)

    def _run_guided(self, parts: List[Tuple[str, str, str]], schemas: List[Dict],
                    temperature, max_tokens, top_p: float = 1.0) -> List[str]:
        """``temperature`` / ``max_tokens`` may be scalars or per-row lists."""
        n = len(parts)
        temps = _per_row(temperature, n, float)
        budgets = _per_row(max_tokens, n, int)
        cap = self.config.max_num_seqs
        derived = self._provisioned_row_cap(parts, budgets)
        if derived is not None:
            cap = min(cap, derived) if cap else derived
        mult = self._dp_mult(cap)
        if cap and _pad_batch(n, mult) > cap:
            step = _chunk_size(cap, mult)
            out: List[str] = []
            for i in range(0, n, step):
                out.extend(self._run_guided(
                    parts[i:i + step], schemas[i:i + step],
                    temps[i:i + step], budgets[i:i + step], top_p,
                ))
            return out
        real_B, B, parts, schemas, temps, budgets = _pad_rows(
            parts, schemas, temps, budgets, multiple=mult
        )
        rows = self._dp_rows(B) if mult > 1 else None
        if rows is not None:
            schemas = schemas[rows]
        guides = [
            compile_schema(
                s, self._token_bytes, vocab_id=self.tokenizer.vocab_id,
                compact=getattr(self.config, "guided_compact_json", False),
            )
            for s in schemas
        ]
        batch = GuidedBatch(guides, device=self.device)
        return self._decode_padded(parts, batch, real_B, temps, budgets, top_p, dp_rows=rows)

    def _run_free(self, full_prompts, temperature, max_tokens, top_p=1.0):
        """Unguided generation: the same loop under a permissive
        one-state automaton; free prompts always take full prefill."""
        parts = [("", "", p) for p in full_prompts]
        n = len(parts)
        temps = _per_row(temperature, n, float)
        budgets = _per_row(max_tokens, n, int)
        cap = self.config.max_num_seqs
        derived = self._provisioned_row_cap(parts, budgets)
        if derived is not None:
            cap = min(cap, derived) if cap else derived
        mult = self._dp_mult(cap)
        if cap and _pad_batch(n, mult) > cap:
            step = _chunk_size(cap, mult)
            out: List[str] = []
            for i in range(0, n, step):
                out.extend(self._run_free(
                    full_prompts[i:i + step], temps[i:i + step],
                    budgets[i:i + step], top_p,
                ))
            return out
        real_B, B, parts, temps, budgets = _pad_rows(parts, temps, budgets, multiple=mult)
        rows = self._dp_rows(B) if mult > 1 else None
        n_rows = B // mult
        batch = GuidedBatch.permissive(n_rows, self.spec.vocab_size, device=self.device)
        texts = self._decode_padded(parts, batch, real_B, temps, budgets, top_p, free=True,
                                    dp_rows=rows)
        return [t.strip() for t in texts]

    # ---------------------------------------------------------- memory budget

    def _kv_row_budget(self) -> Optional[float]:
        """Device bytes for the decode cache: the budgeted fraction of the
        card minus the weights and the (static) prefix-cache reserve."""
        if self._mem_limit is None:
            return None
        reserve = self._prefix_budget if self.prefix_caching and self._prefix_safe else 0
        return self.config.hbm_utilization * self._mem_limit - self._param_bytes - reserve

    def _decode_reserve(self, max_new: int) -> int:
        """Worst-case decode-tail cache slots for ``max_new`` output tokens
        under the CONFIGURED loop: speculative over-allocates its K+1
        verify window, fast-forward its compacted chain tail."""
        if self.spec_decode:
            return spec_decode_slots(max_new, self.spec_k)
        if self.fast_forward:
            return _ff_decode_slots(max_new)
        return max_new + 1

    def worst_case_decode_window(self) -> int:
        """Largest cache length any single admitted row can require."""
        b = max(1, self.max_model_len - 2)
        return (self.max_model_len - b - 1) + self._decode_reserve(b)

    def _auto_pool_blocks(self, block_size: int) -> int:
        """Paged-pool auto-sizing: the WHOLE KV budget becomes one pool —
        ``hbm_utilization`` of the card's memory
        (``torch.cuda.mem_get_info``) minus the weights, with no separate
        prefix reserve (radix-resident prefixes and decode tails draw
        from the same blocks).  Without a device limit (the CPU) the pool
        affords 16 worst-case rows."""
        block_bytes = max(1, block_size * self._kv_slot_bytes * self.spec.num_layers)
        if self._mem_limit:
            budget = self.config.hbm_utilization * self._mem_limit - self._param_bytes
            return max(64, min(1 << 20, int(budget // block_bytes)))
        blocks_per_row = -(-self.worst_case_decode_window() // block_size) + 1
        return 16 * blocks_per_row + 1

    def _paged_build_scratch_blocks(self) -> int:
        """Worst-case TRANSIENT blocks one radix entry build holds past its
        real content: the bucket pad tail of the remainder prefill (freed
        as soon as the insert returns, but live during the build).
        Admission carves it out of the usable pool so that an admitted
        batch cannot run out of blocks mid-prefill; builds run one at a
        time, so one build's worth suffices."""
        bs = self._paged.block_size
        worst = 0
        prev = 0
        for rung in self._suffix_buckets:
            # Smallest block-aligned remainder mapping to this rung.
            lr = (prev // bs + 1) * bs
            if lr > self.max_model_len:
                break
            worst = max(worst, -(-rung // bs) - lr // bs)
            prev = rung
        return worst

    def _paged_scratch_reserve(self) -> int:
        """The entry-build scratch reserve admission subtracts — 0 when
        radix prefix sharing cannot engage."""
        return self._paged_scratch_blocks if self.prefix_caching and self._prefix_safe else 0

    def _paged_usable_blocks(self) -> int:
        """Blocks admission may budget: the pool minus the null block
        minus the scratch reserve, floored at 1."""
        return max(1, self._paged.num_blocks - 1 - self._paged_scratch_reserve())

    def cap_for(self, S: int) -> Optional[int]:
        """Concurrent-row cap for decode-cache length ``S`` (None when
        the device limit is unknown).  Paged: from block accounting — the
        usable pool over the ``ceil(S / bs)`` blocks a row needs (a
        static floor: shared prefix blocks make the real need smaller)."""
        if self._paged is not None:
            # The pool holds the rank's kv heads (tp) and every row (it
            # replicates over dp), so the cap is the pool's alone.
            blocks_per_row = -(-S // self._paged.block_size)
            return max(1, self._paged_usable_blocks() // blocks_per_row)
        budget = self._kv_row_budget()
        if budget is None:
            return None
        # dp rows (one a dp rank) of length S, at the bytes one rank holds.
        per_rows = self._kv_bytes_per_device(self._dp, S)
        return self._dp * max(1, int(budget // per_rows)) if per_rows > 0 else None

    def _kv_bytes_per_device(self, B: int, S: int) -> int:
        """Bytes one rank holds of a dense ``[B, S]`` cache: divided only
        by the mesh axes that engage (``parallel/sharding.py``), in the
        cache's own layout (a quantized cache's values and scales)."""
        if self.mesh is None:
            return B * S * self._kv_slot_bytes * self.spec.num_layers
        from bcg_tpu_torch.parallel.sharding import kv_cache_bytes_per_device

        Hkv, Dh = self.spec.num_kv_heads, self.spec.head_dim
        if self.kv_quantized:
            dh, scale_dtype = Dh, torch.float32
            if self.kv_quantized == "int4":
                from bcg_tpu_torch.models.quantize import kv_int4_layout

                dh, scale_dtype = kv_int4_layout(Dh)
            leaves = [((B, Hkv, S, dh), torch.int8), ((B, Hkv, S), scale_dtype)]
        else:
            leaves = [((B, S, Hkv, Dh), self.kv_dtype)]
        return kv_cache_bytes_per_device(self.mesh, leaves * (2 * self.spec.num_layers),
                                         quantized=bool(self.kv_quantized))

    def _provisioned_row_cap(self, parts, budgets: List[int]) -> Optional[int]:
        """``hbm_utilization`` as a row provisioner: caps the decoded rows
        so cache + weights + prefix reserve fit; None when it all fits or
        the limit is unknown.  A paged engine provisions even without a
        device limit: its pool is finite everywhere."""
        if self._mem_limit is None and self._paged is None:
            return None
        decode_res = self._decode_reserve(max(budgets))
        limit = self.max_model_len - min(budgets) - 1
        B_pad = _pad_batch(len(parts))
        worst = self.cap_for(limit + decode_res)
        if worst is None or worst >= B_pad:
            return None
        longest = max(
            len(self.tokenizer.encode(p + c + t)[-limit:]) for p, c, t in parts
        )
        L = next((b for b in _LEN_BUCKETS if b >= longest), limit)
        cap = self.cap_for(min(L, limit) + decode_res)
        if cap is None or cap >= B_pad:
            return None
        return cap

    def _check_kv_budget(self, B: int, budgets: List[int], decode_res: int) -> None:
        """Warn once when the worst-case KV cache of this batch plus the
        weights exceed ``hbm_utilization`` of the card — for a paged
        engine, when the batch's worst-case block need exceeds the usable
        pool."""
        if self._kv_budget_warned:
            return
        if self._paged is not None:
            bs_blk = self._paged.block_size
            S = self.max_model_len - min(budgets) - 1 + decode_res
            needed = B * (-(-S // bs_blk))
            usable = self._paged_usable_blocks()
            if needed > usable:
                warnings.warn(
                    f"worst-case KV need ({needed} blocks for B={B}, S={S}) exceeds "
                    f"the paged pool ({usable} usable blocks of {bs_blk} tokens); "
                    "bound it with max_num_seqs, a smaller max_model_len, or a "
                    "larger BCG_TPU_KV_POOL_BLOCKS",
                    stacklevel=3,
                )
                self._kv_budget_warned = True
            return
        if self._mem_limit is None:
            return
        S = self.max_model_len - min(budgets) - 1 + decode_res
        kv_total = self._kv_bytes_per_device(B, self._sp_align(S))
        if kv_total + self._param_bytes > self.config.hbm_utilization * self._mem_limit:
            warnings.warn(
                f"worst-case KV cache ({kv_total / 1e9:.1f} GB for B={B}, "
                f"S={S}) plus weights ({self._param_bytes / 1e9:.1f} GB) "
                f"exceeds hbm_utilization={self.config.hbm_utilization} of "
                f"device memory ({self._mem_limit / 1e9:.1f} GB); bound it "
                "with max_num_seqs or a smaller max_model_len",
                stacklevel=3,
            )
            self._kv_budget_warned = True

    # -------------------------------------------------------- public surface

    def generate_json(self, prompt, schema, temperature=0.0, max_tokens=512,
                      system_prompt=None) -> Dict[str, Any]:
        return self.batch_generate_json(
            [(system_prompt or "", prompt, schema)], temperature, max_tokens
        )[0]

    def batch_generate_json(self, prompts, temperature=0.8, max_tokens=512):
        """Rows are (system, user, schema); ``user`` may be a plain string
        or a ``(shared_core, tail)`` pair served from a two-level cached
        prefix.

        Any thread may call it (the serving scheduler's dispatch thread,
        its watchdog's worker), one call at a time per engine.  A thread
        that sets no stream launches on the device's default stream, and
        this engine never sets one: so after a watchdog rebuild, the
        abandoned call on the old engine and the fresh engine's call put
        their kernels on one stream, where they run in launch order and
        the per-device split workspaces (``ops/decode_attention.py``,
        ``ops/w4_matmul.py``) are never used by two kernels at once."""
        if not prompts:
            return []
        # Chaos seam (BCG_TPU_CHAOS `crash|hang|exhaust@engine.generate`):
        # an injected engine failure surfaces exactly where a kernel or
        # runtime crash would — BEFORE the guided run, so no partial
        # cache state is left behind — and reaches the caller's retry
        # ladder (serve dispatch recovery, orchestrator fallback).
        resilience.inject("engine.generate")
        parts = []
        for system_prompt, user_prompt, _ in prompts:
            if isinstance(user_prompt, tuple):
                core, tail = user_prompt
                parts.append(format_chat_parts3(
                    self.config.model_name, system_prompt, core, tail,
                    self.config.disable_qwen3_thinking,
                ))
            else:
                prefix, suffix = format_chat_parts(
                    self.config.model_name, system_prompt, user_prompt,
                    self.config.disable_qwen3_thinking,
                )
                parts.append((prefix, "", suffix))
        schemas = [schema for _, _, schema in prompts]
        try:
            texts = self._run_guided(parts, schemas, temperature, max_tokens)
        except BudgetError as e:
            # ONLY the engine's own budget check degrades to error dicts;
            # kernel and runtime errors must crash, not masquerade as bad
            # model output.
            self.total_rows += len(prompts)
            self.failed_rows += len(prompts)
            return [{"error": "generation_failed", "message": str(e)} for _ in prompts]
        results = []
        for text in texts:
            try:
                results.append(json.loads(text))
            except json.JSONDecodeError:
                salvaged = self.extract_json(text)
                results.append(
                    salvaged if salvaged is not None
                    else {"error": "json_parse_failed", "raw": text[:200]}
                )
        self.total_rows += len(results)
        self.failed_rows += sum(
            1 for r in results if isinstance(r, dict) and "error" in r
        )
        return results

    def generate(self, prompt, temperature=0.0, max_tokens=256, top_p=1.0,
                 system_prompt=None) -> str:
        return self.batch_generate(
            [
                format_chat_prompt(
                    self.config.model_name, system_prompt, prompt,
                    self.config.disable_qwen3_thinking,
                )
                if system_prompt
                else prompt
            ],
            temperature, max_tokens, top_p,
        )[0]

    def batch_generate(self, prompts, temperature=0.0, max_tokens=256, top_p=1.0):
        return self._run_free(prompts, temperature, max_tokens, top_p)

    def kv_pool_stats(self) -> Optional[Dict[str, Any]]:
        """Paged-pool snapshot (block counts, free-block headroom bytes,
        radix prefix hit rate, the attention impl) for serve stats and
        bench JSON; None on a dense engine.  ``pages_per_program`` is a
        TPU grid knob the port does not have: always None."""
        if self._paged is None:
            return None
        stats = self._paged.stats()
        stats["impl"] = self.paged_kv_impl
        stats["kv_dtype"] = self.kv_cache_dtype
        stats["interpret"] = False
        stats["pages_per_program"] = None
        stats["scratch_reserve_blocks"] = self._paged_scratch_reserve()
        return stats

    # ------------------------------------------------------------ mega-round

    def prepare_megaround(self, n_agents: int, lo: int, hi: int,
                          max_rounds: int):
        """Build (and slot-splice-VERIFY) the fused-round plan for this
        engine's tokenizer + chat template, or raise
        ``MegaroundUnsupported`` so the orchestrator falls back to the
        lockstep path.  Dense engines only: the fused round allocates its
        own per-phase caches (a paged pool would need its own round
        program)."""
        from bcg_tpu_torch.engine.megaround import (
            MegaroundTemplate,
            MegaroundUnsupported,
            build_plan,
        )

        if self._paged is not None:
            raise MegaroundUnsupported(
                "paged-KV engine (the fused round allocates dense "
                "per-phase caches)"
            )
        if self.mesh is not None:
            raise MegaroundUnsupported(
                f"multi-device mesh ({self.mesh.size()} ranks)")

        def chat_parts(system: str, user: str):
            return format_chat_parts(
                self.config.model_name, system, user,
                self.config.disable_qwen3_thinking,
            )

        return build_plan(
            MegaroundTemplate(n_agents=n_agents, lo=lo, hi=hi,
                              max_rounds=max_rounds),
            self.tokenizer, chat_parts, self.max_model_len, _LEN_BUCKETS,
        )

    def _megaround_guided(self, schema: Dict, n: int):
        """The guided-decode tables for one schema replicated over ``n``
        rows, on the device, memoized per (schema, n) so steady-state
        rounds reuse the same tensors (no per-round upload).  Built on
        the host and uploaded with :meth:`_upload`, so the first round
        makes no host sync for them either.  Returns ``(batch,
        signature)``."""
        key = (json.dumps(schema, sort_keys=True), n)
        got = self._megaround_guided_memo.get(key)
        if got is None:
            guide = compile_schema(
                schema, self._token_bytes, vocab_id=self.tokenizer.vocab_id,
                compact=getattr(self.config, "guided_compact_json", False),
            )
            # The tables are built (and cached) on the host; this batch's
            # own tensors go up.
            batch = GuidedBatch([guide] * n)
            for name, value in list(vars(batch).items()):
                if torch.is_tensor(value):
                    setattr(batch, name, self._upload(value))
            sig = (batch.num_unique, batch.tables.shape[1], batch.tables.shape[2])
            got = (batch, sig)
            self._megaround_guided_memo[key] = got
        return got

    def _megaround_resident(self, plan):
        """The plan's device arrays, built on its first round and kept for
        one resident plan: per phase the token buffer, its valid mask and
        the static-prefix KV (columns ``[0, prefix_len)`` prefilled once:
        every round prefills only the slot-bearing suffix against it, the
        fused path's analogue of the lockstep prefix cache), then the slot
        token tables and the digit tables of the integer parse.  Each
        phase's cache is sized as the lockstep dense path sizes one for
        the same window and budget, ``L + max_new + 1`` slots."""
        dev = self._megaround_arrays.get(id(plan))
        if dev is not None:
            return dev
        n = plan.n_agents

        def up(a):
            return self._upload(torch.from_numpy(np.ascontiguousarray(a)))

        phase_dev = []
        for phase in (plan.decide, plan.vote):
            base, valid = up(phase.base), up(phase.valid)
            P = phase.prefix_len
            S = phase.L + phase.max_new + 1
            obs_compile.note_shape("megaround_prefix", (n, P, S),
                                   names=("rows", "prefix_len", "cache_len"))
            cache = self._new_cache(n, S)
            _, cache = prefill(self.params, self.spec, base[:, :P].long(), valid[:, :P], cache)
            phase_dev.extend([base, valid, cache])
        dev = tuple(phase_dev) + (up(plan.val_table), up(plan.round_table),
                                  (up(plan.digit_len), up(plan.digit_val)))
        # One resident plan per engine: a game swaps plans rarely
        # (re-prepare), so dead buffers do not accumulate.
        self._megaround_arrays = {id(plan): dev}
        return dev

    def run_megaround(self, plan, values, inbox, round_num: int,
                      receiver_mask, is_byzantine, initial_values,
                      equivocators=None):
        """Run one WHOLE consensus round as one fused program and return
        its :class:`~bcg_tpu_torch.engine.megaround.MegaroundResult` after
        ONE packed readback (``engine.hostsync.site.round_readback``,
        attributed to the ``megaround`` entry) — the round's only host
        sync: the round's inputs go up in one non-blocking copy, the
        decode loops run every step without polling, and the 14 outputs
        come back in one int32 buffer.

        Every per-round quantity is a tensor argument, so the program and
        its shapes are the plan's (the ``megaround`` shape signature: the
        plan's static key + the guided signatures) and a later round adds
        no compile record."""
        from bcg_tpu_torch.engine.megaround import (
            MegaroundResult,
            build_round_program,
        )

        t0 = time.perf_counter()
        n = plan.n_agents
        dev = self._megaround_resident(plan)
        guided_d, sig_d = self._megaround_guided(plan.decide.schema, n)
        guided_v, sig_v = self._megaround_guided(plan.vote.schema, n)
        key = plan.static_key() + (sig_d, sig_v)
        prog = self._megaround_programs.get(key)
        if prog is None:
            obs_compile.note_shape(
                "megaround", key,
                names=("agents", "lo", "hi", "max_rounds", "decide_layout",
                       "vote_layout", "decide_sig", "vote_sig"),
            )
            prog = build_round_program(plan, self)
            self._megaround_programs[key] = prog
        # The round's inputs in one host buffer, one upload: values,
        # inbox, round index, receiver mask, Byzantine flags, initial
        # values, equivocators (equivocators enter as a tensor, like
        # is_byzantine: all-False keeps the exchange the plain broadcast).
        equiv = np.zeros(n, bool) if equivocators is None else np.asarray(equivocators, bool)
        packed = np.concatenate([
            np.asarray(values, np.int32).ravel(), np.asarray(inbox, np.int32).ravel(),
            np.asarray([round_num], np.int32),
            np.asarray(receiver_mask, bool).ravel().astype(np.int32),
            np.asarray(is_byzantine, bool).astype(np.int32),
            np.asarray(initial_values, np.int32), equiv.astype(np.int32),
        ])
        args = torch.split(self._upload(torch.from_numpy(packed)),
                           [n, n * n, 1, n * n, n, n, n])
        values_t, inbox_t, round_t, mask_t, byz_t, init_t, equiv_t = args
        sampler_launches = sample_rows.launches
        with obs_tracer.span(
            "engine.megaround", args={"agents": n, "round": int(round_num)}
        ):
            with obs_compile.time_block("megaround"):
                outs = prog(
                    self.params, *dev, values_t, inbox_t.view(n, n), round_t,
                    mask_t.view(n, n).bool(), byz_t.bool(), init_t, equiv_t.bool(),
                    guided_d, guided_v,
                )
            # THE round's one device->host sync: everything the host
            # needs (values, deliveries, votes, tally, consensus) comes
            # back in one int32 buffer (agreement_pct as its f32 bits).
            flat = torch.cat([
                o.reshape(-1).view(torch.int32) if o.dtype == torch.float32
                else o.reshape(-1).to(torch.int32) for o in outs
            ])
            host = self._read_back("round_readback", "megaround", flat)
        sizes = [n, n, n * n, n, n, n] + [1] * 8
        parts = np.split(host, np.cumsum(sizes)[:-1])
        (proposed, new_values, received, deliveries, vote_raw, votes,
         stop, cont, term, cons_ok, cons_val, cons_pct,
         steps_d, steps_v) = parts
        sampler_launches = sample_rows.launches - sampler_launches
        if sampler_launches:
            obs_counters.inc("engine.sampler.fused_calls", sampler_launches)
        steps = int(steps_d[0]) + int(steps_v[0])
        self.last_decode_steps = steps
        self.total_decode_steps += steps
        self.megaround_rounds += 1
        self.megaround_seconds += time.perf_counter() - t0
        obs_counters.inc("engine.megaround.rounds")
        obs_hostsync.publish()
        _metrics.publish_megaround(self.megaround_stats())
        return MegaroundResult(
            proposed=proposed, values=new_values, received=received.reshape(n, n),
            deliveries=deliveries, vote_raw=vote_raw, votes=votes,
            stop=int(stop[0]), cont=int(cont[0]), terminate=bool(term[0]),
            has_consensus=bool(cons_ok[0]), consensus_value=int(cons_val[0]),
            agreement_pct=float(cons_pct.view(np.float32)[0]), syncs=1,
        )

    def megaround_stats(self) -> Dict[str, Any]:
        """The fused-round block of bench-style stats: fused-round
        volume, the per-round sync profile (1 by construction — exactly
        one ``round_readback`` note per fused round), and fused-round
        throughput over engine wall-clock."""
        return {
            "fused_rounds": self.megaround_rounds,
            "syncs_per_round": 1.0 if self.megaround_rounds else 0.0,
            "rounds_per_sec": (
                self.megaround_rounds / self.megaround_seconds
                if self.megaround_seconds > 0 else 0.0
            ),
        }

    def shutdown(self) -> None:
        """Release the weights, the cached prefix KV, the fused round's
        resident plan and programs and the paged pool, and credit their
        ledger accounts."""
        obs_ledger.credit("params", id(self))
        obs_ledger.credit("prefix_cache", id(self))
        self._megaround_programs.clear()
        self._megaround_arrays.clear()
        self._megaround_guided_memo.clear()
        self._prefix_cache.clear()
        self._prefix_bytes = 0
        if self._paged is not None:
            self._paged.close()
        self._paged = None
        self._paged_call_private = []
        self._paged_toks_memo.clear()
        self.params = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
