"""Parallelism: the single-device game-step bodies of the fused round.

The port of ``bcg_tpu/parallel/``, so far only the dense, mesh-free part
of ``game_step.py`` that the fused mega-round runs
(:mod:`bcg_tpu_torch.parallel.game_step`).  Meshes, weight sharding,
multi-process initialisation and the SPMD exchange collectives are
ROADMAP A13.
"""

from bcg_tpu_torch.parallel.game_step import (
    check_consensus_dense,
    equivocate_proposals,
    masked_exchange,
    masked_exchange_matrix,
    tally_votes_dense,
)

__all__ = [
    "check_consensus_dense",
    "equivocate_proposals",
    "masked_exchange",
    "masked_exchange_matrix",
    "tally_votes_dense",
]
