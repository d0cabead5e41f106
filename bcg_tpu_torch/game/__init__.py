"""Consensus game core — pure-Python state machine, no accelerator needed.

Behavioural clone of the reference's ``byzantine_consensus.py`` with seeded
RNG and the statistics module split out.
"""

from bcg_tpu_torch.game.state import AgentState, ConsensusRound, ByzantineConsensusGame

__all__ = ["AgentState", "ConsensusRound", "ByzantineConsensusGame"]
