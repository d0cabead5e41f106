"""Network topology builders (reference ``agent_network.py:12-87``).

Adjacency-list graphs consumed by protocols and, on the TPU path, compiled
into dense neighbour masks for the all-gather message exchange
(:mod:`bcg_tpu_torch.parallel.game_step`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np


@dataclass
class NetworkTopology:
    num_agents: int
    adjacency_list: Dict[int, List[int]]
    topology_type: str  # fully_connected | ring | grid | custom

    @classmethod
    def fully_connected(cls, num_agents: int) -> "NetworkTopology":
        adj = {i: [j for j in range(num_agents) if j != i] for i in range(num_agents)}
        return cls(num_agents, adj, "fully_connected")

    @classmethod
    def ring(cls, num_agents: int) -> "NetworkTopology":
        adj = {
            i: [(i - 1) % num_agents, (i + 1) % num_agents] for i in range(num_agents)
        }
        return cls(num_agents, adj, "ring")

    @classmethod
    def grid(cls, rows: int, cols: int) -> "NetworkTopology":
        """2-D grid with 4-neighbourhood (reference agent_network.py:47-77 —
        defined there but never reachable from config; wired up here)."""
        adj: Dict[int, List[int]] = {}
        for r in range(rows):
            for c in range(cols):
                idx = r * cols + c
                neighbors = []
                if r > 0:
                    neighbors.append((r - 1) * cols + c)
                if r < rows - 1:
                    neighbors.append((r + 1) * cols + c)
                if c > 0:
                    neighbors.append(r * cols + (c - 1))
                if c < cols - 1:
                    neighbors.append(r * cols + (c + 1))
                adj[idx] = neighbors
        return cls(rows * cols, adj, "grid")

    @classmethod
    def custom(cls, adjacency_list: Dict[int, List[int]]) -> "NetworkTopology":
        return cls(len(adjacency_list), dict(adjacency_list), "custom")

    def neighbor_mask(self) -> np.ndarray:
        """Dense [n, n] bool mask, ``mask[i, j]`` = j is a neighbour of i.

        This is the TPU-native form of the topology: after an
        ``all_gather`` of per-agent (value, vote) tensors over the mesh,
        applying this mask reproduces neighbour-only delivery without any
        per-message routing.
        """
        mask = np.zeros((self.num_agents, self.num_agents), dtype=bool)
        for i, neighbors in self.adjacency_list.items():
            mask[i, neighbors] = True
        return mask

    def receiver_mask(self) -> np.ndarray:
        """Dense [n, n] bool mask in RECEIVER orientation:
        ``mask[i, j]`` = receiver i hears sender j — the transpose of
        :meth:`neighbor_mask`, which is what the delivery paths
        (``runtime/orchestrator._broadcast_receive_spmd`` and the fused
        mega-round's ``parallel/game_step.masked_exchange``) consume.
        Kept as a named surface so the orientation convention lives in
        one place instead of ad-hoc ``.T`` at every call site."""
        return self.neighbor_mask().T.copy()

    @property
    def avg_degree(self) -> float:
        return (
            sum(len(n) for n in self.adjacency_list.values()) / self.num_agents
            if self.num_agents
            else 0.0
        )
