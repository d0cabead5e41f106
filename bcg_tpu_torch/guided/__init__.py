"""Schema-guided JSON decoding, TPU-native.

The reference delegates constrained decoding to vLLM's
``GuidedDecodingParams(json=schema)`` (vllm_agent.py:317-323), which runs a
CPU-side FSM between every decode step.  Under XLA that host round-trip
would stall the TPU each token, so the FSM is compiled AHEAD of time into
static arrays:

    JSON schema --> regex AST --> byte-level DFA --> token-level DFA
    (host, once per schema)            (numpy)        (C++ or numpy)

and applied INSIDE the jitted decode loop as two gathers per step:

    allowed  = token_transitions[dfa_id, state]  >= 0      # [vocab] mask
    state'   = token_transitions[dfa_id, state, sampled]

Per-sequence DFA ids make *heterogeneous* schemas batchable — fixing the
reference's hidden perf cliff where mixed honest/Byzantine schemas defeat
batching entirely (vllm_agent.py:417-455).
"""

from bcg_tpu_torch.guided.schema_compiler import schema_to_ast
from bcg_tpu_torch.guided.dfa import CharDFA, ast_to_dfa
from bcg_tpu_torch.guided.token_dfa import TokenDFA, build_token_dfa
from bcg_tpu_torch.guided.processor import GuidedBatch, compile_schema, SchemaGuide

__all__ = [
    "schema_to_ast",
    "CharDFA",
    "ast_to_dfa",
    "TokenDFA",
    "build_token_dfa",
    "GuidedBatch",
    "SchemaGuide",
    "compile_schema",
]
