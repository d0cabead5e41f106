"""Typed configuration system for the Byzantine Consensus Game.

Re-designs the reference's nine module-level mutable dicts
(``byzantine_consensus_game/config.py:1-77``) as immutable dataclasses.  The
reference mutates config globals from the CLI and from ``run_simulation``
(``main.py:1042-1045, 1094-1102``); here every run receives its own frozen
``BCGConfig`` value, eliminating cross-run state leaks while keeping the same
defaults and knobs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def env_flag(name: str, default: Optional[bool] = None) -> bool:
    """Boolean environment flag — compatibility shim over the central
    registry (:mod:`bcg_tpu_torch.runtime.envflags`), which owns the one
    parse, the defaults, and the docstrings.  ``name`` must be
    registered there (a typo raises instead of silently defaulting);
    ``default=None`` defers to the registered default."""
    from bcg_tpu_torch.runtime.envflags import get_bool

    return get_bool(name, default)

# Model presets used in the reference experiments (config.py:20-25).
MODEL_PRESETS: Dict[str, str] = {
    "qwen3-8b": "Qwen/Qwen3-8B",
    "qwen3-14b": "Qwen/Qwen3-14B",
    "qwen3-32b": "Qwen/Qwen3-32B",
    "mistral-22b": "mistralai/Mistral-Small-Instruct-2409",
    "qwen2.5-7b": "Qwen/Qwen2.5-7B-Instruct",
    "llama3-8b": "meta-llama/Meta-Llama-3.1-8B-Instruct",
    # Hermetic preset: tiny random-weight model + byte tokenizer, runs anywhere.
    "tiny-test": "bcg-tpu/tiny-test",
}

# Default preset used when no model is selected (reference ACTIVE_MODEL,
# config.py:30).  Select models per-run via EngineConfig(model_name=...) or
# resolve_model_name(); this constant is informational, not a mutation knob.
DEFAULT_MODEL = "qwen3-14b"


@dataclass(frozen=True)
class CommunicationConfig:
    """Protocol selection (reference COMMUNICATION_CONFIG, config.py:7-9).

    The lossy-channel knobs apply when ``protocol_type="lossy_sim"``
    (:mod:`bcg_tpu_torch.comm.lossy_sim`): seeded message drops and cross-round
    delivery delays as an experimental axis the reference's idealized
    channel cannot express.
    """

    protocol_type: str = "a2a_sim"
    drop_prob: float = 0.0
    delay_prob: float = 0.0
    max_delay_rounds: int = 1


@dataclass(frozen=True)
class NetworkConfig:
    """Topology selection (reference NETWORK_CONFIG, config.py:12-15).

    Unlike the reference, ``grid`` is actually wired up (the reference lists
    it in config.py:13 but never dispatches to it, main.py:140-147).
    """

    topology_type: str = "fully_connected"  # fully_connected | ring | grid | custom
    custom_adjacency: Optional[Dict[int, List[int]]] = None
    grid_shape: Optional[Tuple[int, int]] = None  # (rows, cols) for grid
    # Route the numeric broadcast/receive phase through XLA collectives
    # (one all_gather over the mesh) instead of the O(n^2) host message
    # loop — the one-agent-per-chip scale path.  Reasoning strings stay
    # host-side; game results are identical either way (tested).
    spmd_exchange: bool = False


@dataclass(frozen=True)
class EngineConfig:
    """Inference engine knobs (reference VLLM_CONFIG, config.py:33-41).

    GPU-specific knobs map onto their TPU equivalents:

    * ``gpu_memory_utilization`` -> ``hbm_utilization`` (KV-cache budget)
    * ``tensor_parallel_size``   -> mesh ``tp`` axis size
    * CUDA attention backend     -> ``attention_impl`` (pallas | xla)
    """

    model_name: str = MODEL_PRESETS["qwen3-14b"]
    backend: str = "torch"  # torch | fake
    max_model_len: int = 8192
    hbm_utilization: float = 0.9
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    sequence_parallel_size: int = 1
    # Cap on concurrently decoded sequences (vLLM max_num_seqs semantics:
    # larger batches process in chunks).  The reference ships 4 as a GPU
    # memory guard (config.py:38); here 0 = unbounded is the right TPU
    # default — decode streams the weights once per step regardless of
    # rows, so artificial serialization only wastes bandwidth.  Set it
    # when KV-cache memory (B x S x layers) must be bounded.
    max_num_seqs: int = 0
    dtype: str = "bfloat16"
    # "int8" stores the KV cache quantized (per-position-per-head absmax
    # scales); the Pallas decode kernel dequantizes in VMEM, halving the
    # HBM traffic of the bandwidth-bound decode step.  "int4" packs the
    # head dim two values per byte with bf16 scales — a CAPACITY knob
    # (admissible batch roughly doubles vs int8 at a fixed HBM budget);
    # the paged Pallas kernel unpacks nibbles in VMEM, the dense cache
    # serves through the dequant fallback.  Env override
    # BCG_TPU_KV_DTYPE={bf16,int8,int4}.
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | int8 | int4
    quantization: Optional[str] = None
    # Prefill the static per-role system prompt once per run and reuse its
    # KV across every round's calls (auto-disabled for template families
    # whose prefix/suffix split is not a special-token boundary).
    prefix_caching: bool = True
    # Block-paged KV cache with radix-tree prefix sharing
    # (engine/paged_kv.py + ops/paged_attention.py): replaces the per-row
    # dense KV slab with a preallocated block pool plus per-row block
    # tables; prompt prefixes shared across rows/rounds (system prompt,
    # accumulated round history) are matched by TOKEN CONTENT in a radix
    # index, stored once, and referenced N times — only each row's short
    # tail prefills.  Greedy output is token-identical to the dense path
    # (tested); admission derives from free blocks instead of the dense
    # worst-case slab.  Opt-in during the transition (env override
    # BCG_TPU_PAGED_KV=1); requires sequence_parallel_size == 1.
    paged_kv: bool = False
    # Paged decode-attention implementation (env override
    # BCG_TPU_PAGED_KV_IMPL): "pallas" = the fused page-gather kernel
    # (ops/paged_attention.py — double-buffered page DMA indexed by the
    # row's block table, online softmax, in-VMEM int8 dequant; interpret
    # mode off-TPU), "xla" = the block-gather reference (bit-identical
    # to dense, the conformance oracle), "auto" = pallas on TPU and xla
    # elsewhere.
    paged_kv_impl: str = "auto"
    # Tokens per KV block (env override BCG_TPU_KV_BLOCK_SIZE).  Smaller
    # blocks share finer prefixes but widen block tables; 16 balances
    # the two at BCG prompt scales (the Pallas paged kernel streams
    # BCG_TPU_PAGED_PAGES_PER_PROGRAM blocks per program, so lane-count
    # windows come from page grouping, not block size — see DESIGN.md).
    kv_block_size: int = 16
    # Pool size in blocks (0 = auto: sized from the HBM budget when the
    # device exposes a limit, else a CPU-test allowance; env override
    # BCG_TPU_KV_POOL_BLOCKS).
    kv_pool_blocks: int = 0
    # Chunked prefill: process full-prompt prefills in slices of this
    # many tokens (0 = one pass).  Caps activation memory at
    # O(batch * chunk) — required to serve 8B-class models on a single
    # 16 GB chip, where whole-prompt prefill temps alone exceed the HBM
    # left after weights + KV cache.
    prefill_chunk: int = 0
    # Forced-chain fast-forward: ride each sampled token's DFA-forced
    # continuation (JSON skeleton) through the same decode weight pass.
    # Greedy-equivalent to the standard loop; ~1.5x decode cache slots
    # (compacted writes); composes with kv_cache_dtype="int8" via the
    # Pallas chunk decode kernel.
    decode_fast_forward: bool = False
    # Prompt-lookup speculative decoding (engine/speculative.py): each
    # iteration drafts up to spec_k continuation tokens by n-gram lookup
    # against the row's own token history (prompt + output so far), with
    # the DFA's forced chains as the always-accepted fallback, and
    # verifies the whole draft in one K+1-position forward pass.
    # Token-identical to the plain loop at temperature 0; standard
    # rejection sampling (distribution-preserving) above it.  Takes
    # precedence over decode_fast_forward when both are set (its drafter
    # subsumes forced chains).  Env overrides: BCG_TPU_SPEC /
    # BCG_TPU_SPEC_K / BCG_TPU_SPEC_NGRAM.
    spec_decode: bool = False
    spec_k: int = 4
    spec_ngram: int = 3
    # Fused guided-sampling kernel (ops/guided_sampler.py): the whole
    # per-step [B, V] masked-sampler pipeline — DFA allowed-mask,
    # EOS gate, temperature, top-p (threshold scan, no sort), draw —
    # as ONE Pallas program per row, shared by the plain/fast-forward/
    # speculative decode loops.  "pallas" = the kernel (interpret mode
    # off-TPU — the parity-test path), "xla" = the reference sampler
    # (the conformance oracle), "auto" = pallas on TPU, xla elsewhere.
    # Greedy rows are token-identical to the xla path; temp>0 rows
    # distribution-preserving (seeded statistical tests).  Env override
    # BCG_TPU_FUSED_SAMPLER.
    fused_sampler: str = "auto"  # auto | pallas | xla
    # Compact-JSON generation grammar: no inter-token whitespace (fewer
    # decoded tokens, longer forced chains).  Output is still valid JSON;
    # off by default for byte-compatibility with the reference's
    # whitespace-tolerant guided outputs.
    guided_compact_json: bool = False
    disable_qwen3_thinking: bool = True
    # Run the layer stack as ONE lax.scan over stacked weights instead of
    # unrolling every layer into the HLO.  Program size becomes O(1) in
    # depth — required where compile infrastructure rejects 36-layer
    # unrolled 8B programs (this environment's remote-compile helper).
    scan_layers: bool = False
    # Finer suffix-length buckets (adds 1536/3072 rungs): decode streams
    # every allocated suffix slot per step, and measured vote suffixes
    # land just past the coarse rungs (up to 40% pad traffic) — opt-in
    # until the extra compile signatures are A/B-measured on hardware.
    # Env BCG_TPU_FINE_SUFFIX=1 also enables it (bench/sweep override).
    fine_suffix_buckets: bool = False
    attention_impl: str = "auto"  # auto | pallas | xla
    # Fake-backend determinism seed (ignored by the real engine).
    fake_seed: int = 0
    # Fake-backend scripted policy (engine/fake.py): a single policy
    # name, or "mixed:<honest>:<byzantine>" for a role-aware adversary
    # mix — a seeded, LLM-free fault-model axis the reference (whose
    # only fault model is the LLM itself) has no equivalent of.
    fake_policy: str = "consensus"
    # Fault injection (engine/fault.py): corrupt this seeded fraction of
    # guided responses to exercise the retry/degradation ladder as a
    # controlled experimental axis.  0 = off.
    fault_rate: float = 0.0
    fault_seed: int = 0


@dataclass(frozen=True)
class AgentConfig:
    """Agent feature flags (reference AGENT_CONFIG, config.py:44-47)."""

    use_structured_output: bool = True
    use_batched_inference: bool = True
    # Vote-phase shared-core prompt caching: restructure vote prompts so
    # the (identical-per-role) proposals+history block is served from a
    # cached KV prefix and only a short per-agent tail prefills.  The
    # restructured prompt moves agent identity/strategy into a tail after
    # the history and drops the per-agent "(you)" marker, so the
    # LLM-visible text diverges from the reference's vote prompt format
    # (bcg_agents.py:475-571).  Opt-in until a real-model A/B shows the
    # distributions match (advisor round-2); requires fully_connected +
    # a2a_sim (identical inboxes) to be sound, which the orchestrator
    # additionally enforces.
    shared_core_votes: bool = False
    # On-device mega-round (ROADMAP item 1, engine/megaround.py): run
    # each consensus round as ONE fused jit entry — prompt assembly from
    # device-resident game state, guided decode, in-jit decision parse,
    # topology-masked exchange, vote tally — with a single per-round
    # readback instead of the lockstep path's 2 calls x 3 syncs.  Uses
    # the compact fixed-width mega-round prompt family (NOT the lockstep
    # history prompts), so it is an experiment-fidelity switch, not a
    # pure optimization; requires structured output + batched inference
    # + an a2a_sim-protocol engine whose tokenizer is byte-stable — any
    # unsupported configuration falls back to lockstep with a one-time
    # warning.  Env override: BCG_TPU_MEGAROUND=1.
    megaround: bool = False


@dataclass(frozen=True)
class LLMConfig:
    """Sampling parameters — single source of truth (reference LLM_CONFIG,
    config.py:52-58)."""

    temperature_decide: float = 0.5
    temperature_vote: float = 0.3
    max_tokens_decide: int = 300
    max_tokens_vote: int = 200
    max_json_retries: int = 3


@dataclass(frozen=True)
class GameConfig:
    """Game parameters (reference BCG_CONFIG, config.py:61-67) plus a seed.

    The reference never seeds its RNG (byzantine_consensus.py:125,138); we
    thread an explicit seed so runs are reproducible when requested.
    """

    num_honest: int = 8
    num_byzantine: int = 0
    value_range: Tuple[int, int] = (0, 50)
    consensus_threshold: float = 66.0
    max_rounds: int = 50
    byzantine_awareness: str = "may_exist"  # may_exist | none_exist
    # Byzantine strategy from the adversary library
    # (scenarios/strategies.py): shapes the adversary prompt persona,
    # selects the scripted FakeEngine mirror, and — for the
    # "equivocate" strategy — routes the exchange through per-receiver
    # proposal tensors.  None = the reference's single disrupt persona
    # (byte-identical prompts).
    byzantine_strategy: Optional[str] = None
    seed: Optional[int] = None


@dataclass(frozen=True)
class MetricsConfig:
    """Result sinks (reference METRICS_CONFIG, config.py:70-77).

    The ``track_*`` flags gate their metric families in the payload
    (runtime/metrics.py) — the reference defines the same flags but
    never reads them; here off = the family's fields are nulled.
    """

    track_convergence: bool = True
    track_byzantine_impact: bool = True
    track_communication: bool = True
    save_results: bool = True
    generate_plots: bool = False
    results_dir: str = "results"
    checkpoint_every_round: bool = False


@dataclass(frozen=True)
class BCGConfig:
    """Top-level bundle of every subsystem config."""

    game: GameConfig = field(default_factory=GameConfig)
    network: NetworkConfig = field(default_factory=NetworkConfig)
    communication: CommunicationConfig = field(default_factory=CommunicationConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)
    agent: AgentConfig = field(default_factory=AgentConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    metrics: MetricsConfig = field(default_factory=MetricsConfig)
    verbose: bool = False

    def replace(self, **kwargs) -> "BCGConfig":
        return dataclasses.replace(self, **kwargs)


def resolve_model_name(name: str) -> str:
    """Map a preset key (e.g. ``qwen3-14b``) to its full model path."""
    return MODEL_PRESETS.get(name, name)
