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
* Attention and sampling run the port's hand-written CUDA kernels on a
  CUDA device, and their plain versions on the CPU (tests).

Only the default ``EngineConfig`` path is ported: bf16 weights and a
dense bf16 KV cache.  Every knob outside it raises ``NotImplementedError``
naming the ROADMAP item that brings it; none is ignored.
"""

from __future__ import annotations

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
from bcg_tpu_torch.engine.tokenizer import Tokenizer, tokenizer_for_model
from bcg_tpu_torch.guided.processor import GuidedBatch, compile_schema
from bcg_tpu_torch.models.configs import ModelSpec, spec_for_model
from bcg_tpu_torch.models.transformer import (
    decode_step,
    init_kv_cache,
    prefill,
    prefill_chunk_at,
    prefill_with_prefix,
)
from bcg_tpu_torch.ops.guided_sampler import make_fused_sampler
from bcg_tpu_torch.runtime import envflags

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


def _pad_batch(real_B: int) -> int:
    """Batch-size bucketing: small (retry) batches round up to a power of
    two; full-size game batches stay exact."""
    return real_B if real_B >= 8 else 1 << (real_B - 1).bit_length()


def _chunk_size(cap: int) -> int:
    """Largest chunk whose padded batch stays within ``cap``."""
    return max(s for s in range(1, cap + 1) if _pad_batch(s) <= cap)


def _pad_rows(*lists):
    """Pad parallel per-sequence lists to the bucketed batch size by
    repeating row 0 (padding rows' results are discarded).
    Returns (real_B, B, *padded_lists)."""
    real_B = len(lists[0])
    B = _pad_batch(real_B)
    return (real_B, B) + tuple(l + [l[0]] * (B - real_B) for l in lists)


def _not_ported(knob: str, item: str):
    return NotImplementedError(
        f"{knob}: not ported to the PyTorch engine yet (ROADMAP {item})"
    )


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TorchEngine(InferenceEngine):
    def __init__(self, config, device=None, params=None,
                 spec: Optional[ModelSpec] = None):
        self.config = config
        self.device = _resolve_device(device)
        self.spec = spec or spec_for_model(config.model_name)
        if self.spec is None:
            raise ValueError(f"No architecture spec for model {config.model_name!r}")
        self._check_config(config)
        self.tokenizer: Tokenizer = tokenizer_for_model(config.model_name)
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

        if params is None:
            from bcg_tpu_torch.models.convert import init_params

            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)
            params = init_params(self.spec, gen, self.device)
        self.params = params
        # Compute dtype follows the weights (bf16 served; the CPU parity
        # tests pass f32 weights, as the JAX engine accepts them); the KV
        # cache is bf16 either way, as in the JAX engine.
        self.kv_dtype = torch.bfloat16
        self._param_bytes = sum(_nbytes(t) for t in self.params.values())
        self._kv_slot_bytes = self.spec.num_kv_heads * self.spec.head_dim * 4

        # Sampling noise: an explicit generator on the engine's device
        # (the JAX engine's PRNGKey(fake_seed)).
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(getattr(config, "fake_seed", 0)))

        self.last_decode_steps = 0
        self.total_decode_steps = 0
        self.total_rows = 0
        self.failed_rows = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0
        self.prefix_fallbacks = 0
        self._prefix_fallback_warned = False
        self._kv_budget_warned = False

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

    # ------------------------------------------------------------ config

    @staticmethod
    def _check_config(config) -> None:
        """The JAX engine's config resolution, narrowed to what the port
        serves: every knob outside the ported path raises."""
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
        if kv_raw != "bfloat16":
            raise _not_ported(f"kv_cache_dtype={kv_raw!r}", "A8")
        if config.quantization not in (None, "int8", "int4"):
            raise ValueError(
                f"quantization={config.quantization!r}: expected None, "
                "'int8' or 'int4'"
            )
        if config.quantization is not None:
            raise _not_ported(f"quantization={config.quantization!r}", "A8")
        if getattr(config, "paged_kv", False) or env_flag("BCG_TPU_PAGED_KV"):
            raise _not_ported("paged_kv", "A9")
        if getattr(config, "decode_fast_forward", False):
            raise _not_ported("decode_fast_forward", "A7")
        if getattr(config, "spec_decode", False) or env_flag("BCG_TPU_SPEC"):
            raise _not_ported("spec_decode", "A7")
        for name in ("tensor_parallel_size", "data_parallel_size",
                     "sequence_parallel_size"):
            if int(getattr(config, name, 1)) > 1:
                raise _not_ported(f"{name}={getattr(config, name)}", "A13")
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

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), device=self.device, dtype=dtype)

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

    def _store_entry(self, key, entry) -> None:
        entry["bytes"] = _nbytes(entry["kv"].buf)
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
        cache = init_kv_cache(self.spec, 1, Pb, self.kv_dtype, self.device)
        _, kv = self._prefill_possibly_chunked(tokens, valid, Pb, cache)
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
                        tail: int):
        """Batch cache ``[B, P + tail]`` whose slots ``[0, Pb)`` of row ``i``
        hold entry ``gid[i]``'s prefix KV (zero past each entry's bucket
        and in the tail) — one copy per distinct entry, all layers at once."""
        P = max(e["bucket"] for e in entries)
        cache = init_kv_cache(self.spec, len(gid), P + tail, self.kv_dtype, self.device)
        for u, e in enumerate(entries):
            rows = torch.as_tensor(np.nonzero(gid == u)[0], device=self.device)
            cache.buf[:, :, rows, : e["bucket"]] = e["kv"].buf
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
        into ``[P, P+Ls)``.  ``None`` when any prefix cannot be cached."""
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
        cache = self._assemble_cache([entries[k] for k in uniq], gid, tail)
        prefix_valid = np.zeros((B, P), dtype=bool)
        prefix_lens = np.zeros((B,), dtype=np.int32)
        for i, (p, c, _) in enumerate(rows):
            e = entries[(p, c)]
            prefix_valid[i, : e["bucket"]] = e["valid"]
            prefix_lens[i] = e["len"]
        return tokens, valid, Ls, cache, prefix_valid, prefix_lens, P, P + tail

    # -------------------------------------------------------------- prefill

    def _prefill_possibly_chunked(self, tokens, valid, L: int, cache,
                                  prefix_valid=None, prefix_lens=None):
        """Prefill ``tokens`` (optionally against a cached prefix in slots
        ``[0, P)``), in ``prefill_chunk``-sized slices when configured."""
        C = self.prefill_chunk
        has_prefix = prefix_valid is not None
        P = prefix_valid.shape[1] if has_prefix else 0
        if not C or L <= C:
            if has_prefix:
                return prefill_with_prefix(
                    self.params, self.spec, self._dev(tokens, torch.long),
                    self._dev(valid), cache, self._dev(prefix_valid),
                    self._dev(prefix_lens, torch.int32),
                )
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

    # ---------------------------------------------------------- decode loop

    def _decode_loop(self, cache, first_logits, valid_mask, prompt_lens, L: int,
                     batch: GuidedBatch, temps, budgets, max_new: int,
                     top_p: float):
        """The guided token loop (``_decode_loop_fn``'s semantics).
        Returns ``(out [B, max_new] int32 on the host, steps)``."""
        spec = self.spec
        eos = self.tokenizer.eos_id
        sampler = make_fused_sampler(eos, top_p)
        row_temp = self._dev(np.asarray(temps, np.float32))
        row_budget = self._dev(np.asarray(budgets, np.int32))

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
            if i % _DONE_CHECK == 0 and bool(done.all()):
                break
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
        return out.cpu().numpy(), int(steps)

    def _decode_batch(self, parts, batch, real_B, temps, budgets, top_p) -> List[str]:
        """Prefill + guided decode for a batch-padded list of
        ``(prefix, core, suffix)`` prompt parts (the dense path of the JAX
        engine's ``_decode_batch_impl``)."""
        B = len(parts)
        max_new = max(budgets)
        decode_slots = max_new + 1
        self._check_kv_budget(B, budgets, decode_slots)
        t0 = time.perf_counter()
        prepped = None
        if self.prefix_caching and self._prefix_safe and all(p for p, _, _ in parts):
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
        if prepped is not None:
            tokens, valid, Ls, cache, prefix_valid, prefix_lens, P, S = prepped
            first_logits, cache = self._prefill_possibly_chunked(
                tokens, valid, Ls, cache,
                prefix_valid=prefix_valid, prefix_lens=prefix_lens,
            )
            L = P + Ls
            valid_mask = np.zeros((B, S), dtype=bool)
            valid_mask[:, :P] = prefix_valid
            valid_mask[:, P:L] = valid
            prompt_lens = (prefix_lens + valid.sum(axis=1)).astype(np.int32)
        else:
            full_prompts = [p + c + t for p, c, t in parts]
            tokens, valid, L = self._prepare_batch(full_prompts, budgets)
            S = L + decode_slots
            cache = init_kv_cache(self.spec, B, S, self.kv_dtype, self.device)
            first_logits, cache = self._prefill_possibly_chunked(tokens, valid, L, cache)
            valid_mask = np.zeros((B, S), dtype=bool)
            valid_mask[:, :L] = valid
            prompt_lens = valid.sum(axis=1).astype(np.int32)
        self._sync()
        t1 = time.perf_counter()
        out_np, steps = self._decode_loop(
            cache, first_logits, self._dev(valid_mask), self._dev(prompt_lens),
            L, batch, temps, budgets, max_new, top_p,
        )
        del cache
        t2 = time.perf_counter()
        self.last_decode_steps = steps
        self.total_decode_steps += steps
        self.prefill_seconds += t1 - t0
        self.decode_seconds += t2 - t1
        if _TIMING:
            print(
                f"[engine] decode B={B} L={L} S={S} max_new={max_new} "
                f"steps={steps} prefill={t1 - t0:.3f}s decode={t2 - t1:.3f}s "
                f"prefix={'hit' if prepped is not None else 'miss'}",
                flush=True, file=sys.stderr,
            )
        texts = []
        for i in range(real_B):
            row = out_np[i]
            end = np.where(row == self.tokenizer.eos_id)[0]
            row = row[: end[0]] if end.size else row
            texts.append(self.tokenizer.decode(row.tolist()))
        return texts

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
        if cap and _pad_batch(n) > cap:
            step = _chunk_size(cap)
            out: List[str] = []
            for i in range(0, n, step):
                out.extend(self._run_guided(
                    parts[i:i + step], schemas[i:i + step],
                    temps[i:i + step], budgets[i:i + step], top_p,
                ))
            return out
        real_B, B, parts, schemas, temps, budgets = _pad_rows(
            parts, schemas, temps, budgets
        )
        guides = [
            compile_schema(
                s, self._token_bytes, vocab_id=self.tokenizer.vocab_id,
                compact=getattr(self.config, "guided_compact_json", False),
            )
            for s in schemas
        ]
        batch = GuidedBatch(guides, device=self.device)
        return self._decode_batch(parts, batch, real_B, temps, budgets, top_p)

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
        if cap and _pad_batch(n) > cap:
            step = _chunk_size(cap)
            out: List[str] = []
            for i in range(0, n, step):
                out.extend(self._run_free(
                    full_prompts[i:i + step], temps[i:i + step],
                    budgets[i:i + step], top_p,
                ))
            return out
        real_B, B, parts, temps, budgets = _pad_rows(parts, temps, budgets)
        batch = GuidedBatch.permissive(B, self.spec.vocab_size, device=self.device)
        texts = self._decode_batch(parts, batch, real_B, temps, budgets, top_p)
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
        """Decode-tail cache slots for ``max_new`` output tokens."""
        return max_new + 1

    def worst_case_decode_window(self) -> int:
        """Largest cache length any single admitted row can require."""
        b = max(1, self.max_model_len - 2)
        return (self.max_model_len - b - 1) + self._decode_reserve(b)

    def cap_for(self, S: int) -> Optional[int]:
        """Concurrent-row cap for decode-cache length ``S`` (None when
        the device limit is unknown)."""
        budget = self._kv_row_budget()
        if budget is None:
            return None
        per_row = S * self._kv_slot_bytes * self.spec.num_layers
        return max(1, int(budget // per_row)) if per_row > 0 else None

    def _provisioned_row_cap(self, parts, budgets: List[int]) -> Optional[int]:
        """``hbm_utilization`` as a row provisioner: caps the decoded rows
        so cache + weights + prefix reserve fit; None when it all fits or
        the limit is unknown."""
        if self._mem_limit is None:
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
        weights exceed ``hbm_utilization`` of the card."""
        if self._kv_budget_warned or self._mem_limit is None:
            return
        S = self.max_model_len - min(budgets) - 1 + decode_res
        kv_total = B * S * self._kv_slot_bytes * self.spec.num_layers
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
        prefix."""
        if not prompts:
            return []
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

    def shutdown(self) -> None:
        """Release the weights and cached prefix KV."""
        self._prefix_cache.clear()
        self._prefix_bytes = 0
        self.params = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
