"""Central registry of environment flags — the ONLY module that reads them.

The port's copy of ``bcg_tpu/runtime/envflags.py``: the same typed
accessors (:func:`get_bool`, :func:`get_int`, :func:`get_str`) over the
subset of the registry that the port's modules read.  An accessor call
with an unregistered name raises, so a typo'd flag name is an error,
not a silently-ignored knob.

Reading is always at CALL time, never import time, so tests can
``monkeypatch.setenv`` freely.  ``python -m
bcg_tpu_torch.runtime.envflags`` prints the registry as a markdown
table.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Union

_FALSY = ("0", "false", "no", "off")


@dataclass(frozen=True)
class EnvFlag:
    """One registered environment knob."""

    name: str
    kind: str  # "bool" | "int" | "str"
    default: Union[bool, int, str, None]
    doc: str


REGISTRY: Dict[str, EnvFlag] = {}


def _register(name: str, kind: str, default, doc: str) -> None:
    if name in REGISTRY:
        raise ValueError(f"env flag {name!r} registered twice")
    REGISTRY[name] = EnvFlag(name=name, kind=kind, default=default, doc=doc)


# --------------------------------------------------------------- registry
_register(
    'VERBOSE', 'bool', False,
    'Force RunLogger console verbosity (reference repo convention).',
)
_register(
    'BCG_TPU_TIMING', 'bool', False,
    'Print per-call prefill/decode wall times and the boot-phase '
    'breakdown to stderr.',
)
_register(
    'BCG_TPU_FINE_SUFFIX', 'bool', False,
    'Enable the fine suffix-length bucket ladder (adds 1536/3072 '
    'rungs); bench/sweep override for '
    'EngineConfig.fine_suffix_buckets.',
)
_register(
    'BCG_TPU_SPEC', 'bool', False,
    'Prompt-lookup speculative decoding (engine/speculative.py): '
    'n-gram drafts verified in one K+1-position forward pass; token- '
    'identical at temperature 0, rejection sampling above.  Override '
    'for EngineConfig.spec_decode.',
)
_register(
    'BCG_TPU_SPEC_K', 'int', 4,
    'Max draft tokens per speculative verify pass (EngineConfig.spec_k '
    'override; chunk width is K+1).',
)
_register(
    'BCG_TPU_SPEC_NGRAM', 'int', 3,
    'Prompt-lookup match length in tokens (EngineConfig.spec_ngram '
    'override).',
)
_register(
    'BCG_TPU_FUSED_SAMPLER', 'str', '',
    'Fused guided-sampling Pallas kernel (EngineConfig.fused_sampler '
    "override): 'pallas' = the whole per-step [B, V] masked-sampler "
    'pipeline as one kernel program per row (ops/guided_sampler.py; '
    "interpret mode off-TPU), 'xla' = the reference sampler (the "
    "conformance oracle), 'auto'/unset = pallas on TPU, xla "
    'elsewhere.',
)
_register(
    'BCG_TPU_KV_DTYPE', 'str', '',
    'KV-cache dtype override (EngineConfig.kv_cache_dtype): '
    "'bf16'/'bfloat16', 'int8' (historical spelling kept as an alias "
    "of itself), or 'int4' (packed two-per-byte + bf16 scales — the "
    'capacity knob that roughly doubles admissible batch vs int8 at a '
    'fixed HBM budget); unset = the config field.',
)
_register(
    'BCG_TPU_PAGED_KV', 'bool', False,
    'Enable the block-paged KV cache with radix-tree prefix sharing '
    '(EngineConfig.paged_kv override): shared prompt prefixes are '
    'stored once in a block pool and referenced per row via block '
    'tables; greedy output token-identical to the dense path.',
)
_register(
    'BCG_TPU_KV_BLOCK_SIZE', 'int', 0,
    'Tokens per KV block for the paged cache (0 = use '
    'EngineConfig.kv_block_size, default 16).',
)
_register(
    'BCG_TPU_KV_POOL_BLOCKS', 'int', 0,
    'Paged KV pool size in blocks (0 = use EngineConfig.kv_pool_blocks, '
    'whose 0 = auto-size from the device memory budget / CPU-test allowance).',
)
_register(
    'BCG_TPU_PAGED_KV_IMPL', 'str', '',
    'Paged decode-attention implementation (EngineConfig.paged_kv_impl '
    "override).  On CUDA 'auto' and 'pallas' both run the paged kernel "
    "(csrc/paged_attention.cu) and 'xla' (the gather oracle) is refused; "
    'on the CPU every value runs the plain gather version.',
)
_register(
    'BCG_TPU_SCENARIO', 'str', None,
    'Adversary scenario from the registry (bcg_tpu/scenarios): any '
    "BCGSimulation construction overlays the named entry's strategy, "
    'topology, channel, awareness, and agent split onto its config '
    '(apply_scenario) — bench/api/CLI single runs get registry-true '
    'adversary configs without new plumbing.  Unknown names fail '
    'loudly; unset = the config as given.',
)
_register(
    'BCG_TPU_SERVE_CHECKPOINT_EVERY', 'int', 0,
    'Write a resumable checkpoint every N game rounds '
    '(runtime/checkpoint.py), independent of --checkpoint-every- '
    'round; 0 = off.',
)
_register(
    'BCG_TPU_MEGAROUND', 'bool', False,
    'On-device mega-round (ROADMAP item 1, engine/megaround.py): run '
    'each consensus round as ONE fused jit entry (prompt assembly, '
    'guided decode, in-jit parse, masked exchange, vote tally) with a '
    'single per-round readback.  Equivalent to AgentConfig.megaround; '
    'unsupported configurations (free-text decisions, sequential '
    'orchestrator, paged/multi-device engines, non-byte-stable '
    'tokenizers) fall back to the lockstep path with a one-time '
    'warning.',
)
_register(
    'BCG_TPU_FAULT_RATE', 'str', '',
    'Seeded response-corruption rate for FaultInjectingEngine '
    '(engine/fault.py), overriding EngineConfig.fault_rate / --fault- '
    "rate: a float in [0, 1]; ''/unset = the config field. Injections "
    'count in engine.faults.injected and land in bench JSON as the '
    "'faults' block.",
)


# -------------------------------------------------------------- accessors
def _lookup(name: str) -> EnvFlag:
    flag = REGISTRY.get(name)
    if flag is None:
        raise KeyError(
            f"env flag {name!r} is not registered in "
            f"bcg_tpu_torch.runtime.envflags — add it to the registry"
        )
    return flag


def parse_bool(raw: Optional[str], default: bool = False) -> bool:
    """ONE boolean parse for the whole package: unset/empty -> default;
    '0'/'false'/'no'/'off' (case/whitespace-insensitive) -> False;
    anything else -> True."""
    if raw is None or raw.strip() == "":
        return default
    return raw.strip().lower() not in _FALSY


def is_set(name: str) -> bool:
    """True when the (registered) flag is present in the environment at
    all — for call sites whose default depends on other state."""
    return os.environ.get(_lookup(name).name) is not None


def get_bool(name: str, default: Optional[bool] = None) -> bool:
    """Boolean flag value; ``default`` overrides the registered default
    (for size-class-dependent call sites)."""
    flag = _lookup(name)
    if flag.kind != "bool":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not bool")
    fallback = flag.default if default is None else default
    return parse_bool(os.environ.get(name), bool(fallback))


def get_int(name: str, default: Optional[int] = None) -> int:
    """Integer flag value; unset/empty -> default; unparseable -> default
    with a LOUD stderr warning (silently recording a run under the wrong
    window/rounds config would be worse than either crashing or
    defaulting)."""
    flag = _lookup(name)
    if flag.kind != "int":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not int")
    fallback = int(flag.default if default is None else default)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return fallback
    try:
        return int(raw)
    except ValueError:
        import sys

        print(
            f"envflags: {name}={raw!r} is not an integer — using "
            f"{fallback}",
            file=sys.stderr,
        )
        return fallback


def get_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String flag value; unset -> default (which may be None)."""
    flag = _lookup(name)
    if flag.kind != "str":
        raise TypeError(f"env flag {name} is kind={flag.kind}, not str")
    fallback = flag.default if default is None else default
    raw = os.environ.get(name)
    return fallback if raw is None else raw


def overrides() -> Dict[str, str]:
    """Raw values of every REGISTERED flag present in the environment —
    the run-manifest form (JSONL sink headers record exactly what was
    overridden, so sweep-level grouping is mechanical).  Raw strings,
    not parsed values: a manifest must round-trip what the operator set,
    and the registry accessors cannot represent "was unset"."""
    out = {}
    for name in REGISTRY:
        raw = os.environ.get(name)
        if raw is not None:
            out[name] = raw
    return dict(sorted(out.items()))


# ------------------------------------------------------------------ docs
def markdown_table() -> str:
    """Registry as a README-ready markdown table."""
    lines = [
        "| Flag | Type | Default | Meaning |",
        "| --- | --- | --- | --- |",
    ]
    for flag in REGISTRY.values():
        default = "(unset)" if flag.default is None else repr(flag.default)
        lines.append(
            f"| `{flag.name}` | {flag.kind} | `{default}` | {flag.doc} |"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    print(markdown_table())
