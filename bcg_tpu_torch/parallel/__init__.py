"""Parallelism over ``torch.distributed`` — the port of
``bcg_tpu/parallel/``: the ``("dp", "tp", "sp")`` mesh of ranks
(:mod:`~bcg_tpu_torch.parallel.mesh`), joining and starting worlds
(:mod:`~bcg_tpu_torch.parallel.distributed`), the collectives each mesh
dimension needs (:mod:`~bcg_tpu_torch.parallel.collectives`), weight and
cache layouts (:mod:`~bcg_tpu_torch.parallel.sharding`), and the game
step's dense and SPMD forms (:mod:`~bcg_tpu_torch.parallel.game_step`).
``bcg_tpu/parallel/compat.py`` (a JAX version shim) has no counterpart.
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
