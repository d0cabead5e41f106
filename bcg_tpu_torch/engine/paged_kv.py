"""Host-side manager for the block-paged KV cache: block allocator +
radix-tree prefix index with refcounts and LRU eviction — the port of
``bcg_tpu/engine/paged_kv.py``.

The device side (pool layout, block-indexed writes and gathers, paged
attention) lives in :mod:`bcg_tpu_torch.ops.paged_attention`; this
module owns everything the host decides per call:

* **Block pool bookkeeping** — a free list over ``[1, num_blocks)``
  (block 0 is the reserved null block that table padding points at),
  allocation with eviction pressure, and the ``kvpool.*`` gauges and
  counters (blocks total / free / resident, headroom bytes, evicted
  blocks, hit and lookup positions) refreshed wherever the resident or
  free set changes.

* **Radix index** — a tree over TOKEN IDS at block granularity: each
  node is one full block (``block_size`` tokens, the edge label from
  its parent) holding the physical block id.  ``lookup`` walks the
  longest matching full-block chain; ``insert`` extends a matched path
  with freshly prefilled blocks.  Matching on token content means
  sharing needs no string-level keys: two different system prompts
  share exactly their common token-prefix blocks, and round ``r``'s
  grown history prompt extends round ``r-1``'s resident chain instead
  of re-prefilling it.

* **Refcounts / eviction** — nodes on a batch's matched or inserted
  paths are PINNED (refcount) for the duration of the call, so eviction
  can never free a block an in-flight decode still references.
  Eviction (LRU over leaf nodes, only at refcount 0) runs under
  allocation pressure.

* **Chaos seam** — ``BCG_TPU_CHAOS=exhaust@kvpool.alloc`` injects pool
  exhaustion at the top of :meth:`PagedKV.alloc`.

The radix tree, the allocator, the pins, the eviction order and
:meth:`PagedKV.stats` are the JAX package's, decision for decision: the
same calls leave both engines with the same resident, free and hit
counts, and the same ``kvpool.*`` telemetry.  Four things differ:

* the pool is allocated by the port's ``init_block_pool`` on the
  engine's device (one buffer per kind, per-layer views; under a mesh
  the rank's kv heads, and every row's writes under ``dp``:
  :class:`PagedCache`);
* :meth:`PagedKV.entries` hands every layer the pool plus ONE ``[B,
  nblk]`` int32 table tensor (the JAX per-layer copies exist only to
  avoid aliasing under buffer donation);
* there is no ``adopt``: the model writes the pool in place, so no
  call returns a new pool to re-adopt;
* the pool charges no ledger account: the engine charges the radix-
  resident blocks to ``prefix_cache`` at the end of each call (one site,
  and a charge replaces the amount, so the account reads the same bytes).

Thread-safety: called only from the engine's generation path, which is
serialised — no internal locking, same contract as the dense prefix
cache.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bcg_tpu_torch.obs import counters as obs_counters
from bcg_tpu_torch.runtime import resilience


class PoolExhausted(RuntimeError):
    """Allocation failed even after evicting every unpinned block —
    the pinned working set plus the request exceeds the pool."""


class PagedCache(list):
    """A model call's paged entries (one per layer).  ``dp_split``: the
    rows are this rank's share of a batch split over ``dp``; the pool
    replicates over ``dp`` (kv heads alone split, over ``tp``), so each
    write gathers every ``dp`` rank's rows and every rank's pool takes
    them all — the pools, their allocators and radix trees stay equal, as
    GSPMD keeps one replicated pool (``models/transformer._paged_index``).
    The host side stays whole-batch on every rank: each rank assembles
    the whole batch's tables, so the allocations, the radix hits and the
    ``kvpool.*`` telemetry are the JAX pool's."""

    def __init__(self, entries, dp_split: bool = False):
        super().__init__(entries)
        self.dp_split = dp_split


class _Node:
    """One radix node = one full resident block.  ``key`` is the
    block's token chunk (the edge label from ``parent``)."""

    __slots__ = ("key", "block", "children", "parent", "refcount", "last_use")

    def __init__(self, key: Optional[Tuple[int, ...]], block: Optional[int],
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.refcount = 0
        self.last_use = 0


class PagedKV:
    """Block pool + radix prefix index for one engine.

    ``pool`` is the device-resident per-layer block pool
    (:func:`bcg_tpu_torch.ops.paged_attention.init_block_pool`).  The
    manager never touches block CONTENTS — only ids and refcounts.
    """

    def __init__(self, spec, num_blocks: int, block_size: int, *,
                 quantized=False, device="cpu"):
        if num_blocks < 2:
            raise ValueError(f"num_blocks={num_blocks}: need >= 2 (block 0 "
                             "is the reserved null block)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size}: need >= 1")
        self.spec = spec
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.quantized = quantized
        self.device = torch.device(device)
        self._free: List[int] = list(range(1, self.num_blocks))
        self._root = _Node(None, None, None)
        self._clock = itertools.count(1)
        self._pinned: List[_Node] = []
        self.resident_blocks = 0
        # Instance-local hit accounting (the prefix-hit-rate metric).
        self._hit_positions = 0
        self._lookup_positions = 0
        self.pool = self._init_pool()
        self.block_bytes_dev = self._block_bytes()
        obs_counters.set_gauge("kvpool.blocks_total", self.num_blocks - 1)
        self._publish()

    # ------------------------------------------------------------ device pool

    def _init_pool(self):
        from bcg_tpu_torch.ops.paged_attention import init_block_pool

        return init_block_pool(self.spec, self.num_blocks, self.block_size,
                               quantized=self.quantized, device=self.device)

    def _block_bytes(self) -> int:
        """One block across every layer: the unit the free-block
        admission math accounts in."""
        total = sum(t.numel() * t.element_size() for e in self.pool for t in e.values())
        return max(1, total // self.num_blocks)

    def entries(self, tbl: np.ndarray, dp_split: bool = False) -> "PagedCache":
        """Paged cache entries for a model call: the pool plus the block
        table, one ``[B, nblk]`` int32 tensor on the pool's device shared
        by every layer.  ``dp_split``: the table holds this rank's rows of
        a batch split over ``dp``, whose writes every rank's pool takes
        (:class:`PagedCache`)."""
        t = torch.as_tensor(np.asarray(tbl, dtype=np.int32), device=self.device)
        return PagedCache([{**e, "tbl": t} for e in self.pool], dp_split)

    def invalidate(self) -> None:
        """Engine-failure recovery: a call that raised mid-write leaves
        block contents undefined — drop every resident block and reset the
        pool to its initial zeros (scales ones) so the engine stays usable
        (the radix working set re-prefills on demand).  The reset is in
        place: a fresh pool would need its memory twice while the failed
        call's frames still hold the old one."""
        self._root = _Node(None, None, None)
        self._pinned = []
        self._free = list(range(1, self.num_blocks))
        self.resident_blocks = 0
        for e in self.pool:
            for name, t in e.items():
                t.fill_(1 if name.endswith("_scale") else 0)
        self._publish()

    # -------------------------------------------------------------- allocator

    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` block ids off the free list, evicting unpinned
        radix leaves (LRU-first) under pressure.  Raises
        :class:`PoolExhausted` when the pinned resident set leaves no
        room — admission (``cap_for`` on free blocks) exists to make
        that unreachable in correctly-sized deployments."""
        # Chaos seam (BCG_TPU_CHAOS `exhaust@kvpool.alloc`): injected
        # pool exhaustion exercises the same PoolExhausted path a
        # mis-sized pool would, upstream of any state mutation.
        resilience.inject("kvpool.alloc")
        if n > len(self._free):
            self.evict(n - len(self._free))
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} KV blocks but only {len(self._free)} free and "
                f"nothing evictable ({self.resident_blocks} resident, "
                f"{sum(1 for _ in self._iter_nodes())} radix nodes pinned "
                "or interior); raise BCG_TPU_KV_POOL_BLOCKS or lower "
                "concurrency"
            )
        out = self._free[:n]
        del self._free[:n]
        self._publish()
        return out

    def free(self, ids: Sequence[int]) -> None:
        """Return PRIVATE (never radix-inserted) blocks to the free
        list.  Contents are dead; the null block 0 is never accepted."""
        self._free.extend(i for i in ids if i != 0)
        self._publish()

    def _iter_nodes(self):
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            yield node
            stack.extend(node.children.values())

    def evict(self, need: int) -> int:
        """Free up to ``need`` radix-resident blocks: leaf nodes only
        (children pin their parents structurally), refcount 0 only
        (in-flight batches pin their paths), LRU order.  Cascades —
        evicting a leaf may expose its parent, which joins the heap the
        moment it becomes evictable.  ONE tree walk per call (a heap of
        candidates), not one per freed block.  Returns blocks freed."""
        heap = [
            (node.last_use, id(node), node) for node in self._iter_nodes()
            if not node.children and node.refcount == 0
        ]
        heapq.heapify(heap)
        freed = 0
        while freed < need and heap:
            _, _, victim = heapq.heappop(heap)
            parent = victim.parent
            del parent.children[victim.key]
            self._free.append(victim.block)
            self.resident_blocks -= 1
            freed += 1
            obs_counters.inc("kvpool.evicted_blocks")
            if (parent is not self._root and not parent.children
                    and parent.refcount == 0):
                heapq.heappush(heap, (parent.last_use, id(parent), parent))
        if freed:
            self._publish()
        return freed

    # ------------------------------------------------------------ radix index

    def lookup(self, toks: np.ndarray) -> Tuple[List[_Node], List[int]]:
        """Longest full-block match of ``toks`` against the tree.
        Returns the matched node path and their block ids; counts
        hit/lookup positions for the prefix-hit-rate metric."""
        bs = self.block_size
        node = self._root
        path: List[_Node] = []
        blocks: List[int] = []
        now = next(self._clock)
        full = len(toks) // bs
        for i in range(full):
            key = tuple(int(t) for t in toks[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = now
            path.append(child)
            blocks.append(child.block)
            node = child
        self._hit_positions += len(blocks) * bs
        self._lookup_positions += full * bs
        obs_counters.inc("kvpool.hit_positions", len(blocks) * bs)
        obs_counters.inc("kvpool.lookup_positions", full * bs)
        return path, blocks

    def pin(self, nodes: Sequence[_Node]) -> None:
        """Refcount-pin a path for the duration of the current call —
        pinned nodes are invisible to :meth:`evict`."""
        for node in nodes:
            node.refcount += 1
            self._pinned.append(node)

    def unpin_all(self) -> None:
        """Release every pin taken since the last release (end of the
        engine call's ``finally``)."""
        for node in self._pinned:
            node.refcount -= 1
        self._pinned = []

    def insert(self, parent_path: List[_Node], toks: np.ndarray,
               start_tok: int, block_ids: Sequence[int]) -> List[_Node]:
        """Graft freshly prefilled blocks onto the tree after
        ``parent_path`` (the lookup result): block ``j`` holds tokens
        ``[start_tok + j*bs, start_tok + (j+1)*bs)`` of ``toks``.  A
        chunk already present (raced in by an earlier entry of the same
        batch) reuses the existing node; the duplicate block stays
        CALLER-owned (the caller frees whatever the grafted path did
        not keep — insert freeing it too would put one id on the free
        list twice).  New nodes are pinned."""
        bs = self.block_size
        node = parent_path[-1] if parent_path else self._root
        now = next(self._clock)
        grafted: List[_Node] = []
        for j, block in enumerate(block_ids):
            lo = start_tok + j * bs
            key = tuple(int(t) for t in toks[lo:lo + bs])
            child = node.children.get(key)
            if child is None:
                child = _Node(key, int(block), node)
                node.children[key] = child
                self.resident_blocks += 1
            child.last_use = now
            grafted.append(child)
            node = child
        self.pin(grafted)
        self._publish()
        return grafted

    # ------------------------------------------------------------ accounting

    def _publish(self) -> None:
        obs_counters.set_gauge("kvpool.blocks_free", len(self._free))
        obs_counters.set_gauge("kvpool.blocks_resident", self.resident_blocks)
        obs_counters.set_gauge(
            "kvpool.headroom_bytes", len(self._free) * self.block_bytes_dev
        )

    def close(self) -> None:
        """Engine shutdown: release the pool's device memory and zero the
        published pool gauges so dead-pool telemetry (resident blocks,
        headroom) cannot outlive the engine in the Prometheus export or
        trace reports."""
        self.pool = []
        for name in ("kvpool.blocks_total", "kvpool.blocks_free",
                     "kvpool.blocks_resident", "kvpool.headroom_bytes"):
            obs_counters.set_gauge(name, 0)

    def stats(self) -> Dict[str, Optional[float]]:
        """Pool/headroom snapshot for serve stats and bench JSON."""
        hits = self._hit_positions
        lookups = self._lookup_positions
        return {
            "block_size": self.block_size,
            "blocks_total": self.num_blocks - 1,
            "blocks_free": len(self._free),
            "blocks_resident": self.resident_blocks,
            "free_block_headroom_bytes": (
                len(self._free) * self.block_bytes_dev
            ),
            "prefix_hit_rate": (
                round(hits / lookups, 4) if lookups else None
            ),
        }
