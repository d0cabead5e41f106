"""HBM ledger: live per-device byte accounting of what the engine holds.

The allocator's ``bytes_in_use`` says how much HBM is gone but never
WHAT it is; the engine's budget math (``_kv_row_budget`` /
``cap_for``) models what SHOULD fit but records nothing at runtime.
The ledger is the missing middle: every long-lived device allocation
the serving stack makes is charged to a named account when it
materializes and credited back when it is released, so at any instant
``snapshot()`` decomposes device memory into params / decode-KV slabs /
prefix-cache entries / speculative decode-slot over-allocation — the
accounting substrate ROADMAP item 1's paged-KV work will assert its
superlinear-win claims against.

Accounts are keyed: ``charge(account, key, nbytes)`` is idempotent per
key (re-charging a key replaces its amount — a re-used cache shape does
not double-count) and ``credit(account, key)`` of an unknown key is a
no-op (eviction paths may race shutdown).  All amounts are PER-DEVICE
bytes — callers compute them through
``parallel/sharding.tree_bytes_per_device`` /
``kv_cache_bytes_per_device`` so the ledger and the engine's admission
math cannot drift apart.

Every mutation republishes gauges (``hbm.<account>_bytes``,
``hbm.total_bytes``, and — when a device limit was declared —
``hbm.limit_bytes`` / ``hbm.headroom_bytes``) into the process-wide
counter registry, so the ledger rides bench JSON, serve stats, and the
Prometheus exposition with no extra plumbing.  :func:`reconcile`
compares the ledger total against the allocator's actual reading
(``runtime/metrics._device_memory``) when real devices are present —
the drift gauge (``hbm.unaccounted_bytes``) is what flags a leak or an
unledgered allocation class.

No jax import — loadable by flag-only consumers.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from bcg_tpu_torch.obs import counters as obs_counters

# Published accounts, in render order.  "spec_slots" is the decode-tail
# OVER-allocation of the speculative/fast-forward loops (cache slots
# past max_new+1) — carved out of the kv_cache charge by the engine so
# the cost of speculation's K+1 verify window is first-class.
ACCOUNTS = ("params", "kv_cache", "prefix_cache", "spec_slots")


class HbmLedger:
    """Keyed per-account byte ledger; one process-wide instance
    (:data:`LEDGER`) mirrors itself into registry gauges."""

    def __init__(self, publish: bool = True):
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[object, int]] = {a: {} for a in ACCOUNTS}
        self._limit: Optional[int] = None
        self._publish = publish

    # ------------------------------------------------------------- mutation

    def set_limit(self, limit_bytes: Optional[int]) -> None:
        """Declare the per-device capacity (engine boot; None on CPU —
        headroom then stays unpublished rather than lying)."""
        with self._lock:
            self._limit = limit_bytes
        self._republish()

    def charge(self, account: str, key: object, nbytes: int) -> None:
        if account not in self._entries:
            raise KeyError(
                f"unknown ledger account {account!r}; known: {ACCOUNTS}"
            )
        with self._lock:
            self._entries[account][key] = int(nbytes)
        self._republish()

    def credit(self, account: str, key: object) -> None:
        if account not in self._entries:
            raise KeyError(
                f"unknown ledger account {account!r}; known: {ACCOUNTS}"
            )
        with self._lock:
            self._entries[account].pop(key, None)
        self._republish()

    def credit_all(self, account: str) -> None:
        """Drop every key of one account (engine shutdown)."""
        with self._lock:
            self._entries[account].clear()
        self._republish()

    def reset(self) -> None:
        """Full wipe — TEST-ONLY (live engines hold charged keys)."""
        with self._lock:
            for account in self._entries.values():
                account.clear()
            self._limit = None
        self._republish()

    # -------------------------------------------------------------- reading

    def total(self, account: Optional[str] = None) -> int:
        with self._lock:
            if account is not None:
                return sum(self._entries[account].values())
            return sum(
                sum(keys.values()) for keys in self._entries.values()
            )

    def headroom(self) -> Optional[int]:
        """Per-device bytes the declared limit still affords, or None
        when no limit was declared (CPU)."""
        with self._lock:
            if self._limit is None:
                return None
            used = sum(sum(keys.values()) for keys in self._entries.values())
            return self._limit - used

    def snapshot(self) -> Dict[str, Optional[int]]:
        """Flat dict for bench JSON / serve stats: per-account bytes,
        total, limit and headroom (absent-limit entries are None)."""
        with self._lock:
            out: Dict[str, Optional[int]] = {
                f"{a}_bytes": sum(keys.values())
                for a, keys in self._entries.items()
            }
            total = sum(v for v in out.values() if v)
            out["total_bytes"] = total
            out["limit_bytes"] = self._limit
            out["headroom_bytes"] = (
                self._limit - total if self._limit is not None else None
            )
        return out

    def reconcile(self) -> Dict[str, Optional[int]]:
        """Compare the ledger against the allocator's actual per-device
        reading (max across devices, ``runtime/metrics._device_memory``).
        Publishes ``hbm.device_bytes_in_use`` and
        ``hbm.unaccounted_bytes`` (allocator minus ledger; transient
        workspace and XLA temp buffers land here) when the backend
        exposes allocator stats; on CPU returns the ledger view with
        both set to None."""
        from bcg_tpu_torch.runtime.metrics import _device_memory

        in_use, _peak = _device_memory()
        snap = self.snapshot()
        snap["device_bytes_in_use"] = in_use
        snap["unaccounted_bytes"] = (
            in_use - snap["total_bytes"] if in_use is not None else None
        )
        if self._publish and in_use is not None:
            obs_counters.set_gauge("hbm.device_bytes_in_use", in_use)
            obs_counters.set_gauge(
                "hbm.unaccounted_bytes", snap["unaccounted_bytes"]
            )
        return snap

    # ------------------------------------------------------------ publishing

    def _republish(self) -> None:
        if not self._publish:
            return
        snap = self.snapshot()
        for account in ACCOUNTS:
            obs_counters.set_gauge(
                f"hbm.{account}_bytes", snap[f"{account}_bytes"] or 0
            )
        obs_counters.set_gauge("hbm.total_bytes", snap["total_bytes"])
        if snap["limit_bytes"] is not None:
            obs_counters.set_gauge("hbm.limit_bytes", snap["limit_bytes"])
            obs_counters.set_gauge("hbm.headroom_bytes", snap["headroom_bytes"])


# The single process-wide ledger (mirrors the REGISTRY idiom).
LEDGER = HbmLedger()


def charge(account: str, key: object, nbytes: int) -> None:
    LEDGER.charge(account, key, nbytes)


def credit(account: str, key: object) -> None:
    LEDGER.credit(account, key)


def credit_all(account: str) -> None:
    LEDGER.credit_all(account)


def set_limit(limit_bytes: Optional[int]) -> None:
    LEDGER.set_limit(limit_bytes)


def snapshot() -> Dict[str, Optional[int]]:
    return LEDGER.snapshot()


def reconcile() -> Dict[str, Optional[int]]:
    return LEDGER.reconcile()


def headroom() -> Optional[int]:
    return LEDGER.headroom()


def reset() -> None:
    LEDGER.reset()
