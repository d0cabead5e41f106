// Token-level DFA builder.
//
// Native equivalent of the FSM machinery the reference gets from vLLM's
// guided-decoding backend (vllm_agent.py:317-323): for every (DFA state,
// vocabulary token) pair, walk the token's bytes through the byte-level
// DFA and record the resulting state (-1 = the token is forbidden in that
// state).  This is the O(states x vocab x token_len) hot loop of schema
// compilation, run once per schema on the host; the produced table is
// uploaded to the TPU and consulted with gathers inside the jitted decode
// loop.
//
// Build: g++ -O2 -shared -fPIC -o libtokendfa.so token_dfa.cpp

#include <cstdint>

extern "C" {

// char_trans: [num_states, 256] int32, -1 = reject
// token_bytes: flattened token byte data (uint8), token i occupies
//              [offsets[i], offsets[i+1])
// out: [num_states, vocab] int32 transition table
void build_token_dfa(const int32_t* char_trans,
                     int32_t num_states,
                     const uint8_t* token_bytes,
                     const int64_t* offsets,
                     int32_t vocab,
                     int32_t* out) {
  for (int32_t s = 0; s < num_states; ++s) {
    const int64_t row = static_cast<int64_t>(s) * vocab;
    for (int32_t t = 0; t < vocab; ++t) {
      int32_t state = s;
      for (int64_t p = offsets[t]; p < offsets[t + 1]; ++p) {
        state = char_trans[static_cast<int64_t>(state) * 256 + token_bytes[p]];
        if (state < 0) break;
      }
      out[row + t] = state;
    }
  }
}

}  // extern "C"
