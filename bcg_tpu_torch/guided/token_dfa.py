"""Byte-level DFA -> token-level DFA.

For each (DFA state, token) pair, walking the token's bytes through the
char DFA yields the next state (or -1: token forbidden).  The resulting
``[num_states, vocab]`` int32 table is the entire guided-decoding runtime
state — two gathers per decode step on the device.

Two builders:

* C++ (``native/token_dfa.cpp``), compiled on first use with g++ and
  called via ctypes — the production path for 150K-token vocabularies.
* A vectorised numpy fallback (used automatically when no compiler is
  available), identical output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from bcg_tpu_torch.guided.dfa import CharDFA

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
# The compiled builder lands in the repo's gitignored build tree, never
# next to the source.
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "bcg_tpu_torch",
)
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


_UNREACHABLE = np.iinfo(np.int32).max // 2  # dist sentinel: accept unreachable


@dataclass
class TokenDFA:
    """Token-level automaton for one schema.

    transitions: int32 [num_states, vocab]; -1 = token forbidden
    accepting:   bool [num_states]; EOS legal exactly here
    start:       int
    dist:        int32 [num_states]; tokens on the shortest path to an
                 accepting state (0 there).  The decode loop masks any
                 token whose next state cannot finish within the
                 remaining budget (guaranteed-parse decoding)
    """

    transitions: np.ndarray
    accepting: np.ndarray
    start: int
    dist: np.ndarray

    @property
    def num_states(self) -> int:
        return self.transitions.shape[0]

    @property
    def vocab_size(self) -> int:
        return self.transitions.shape[1]


def completion_paths(
    transitions: np.ndarray, accepting: np.ndarray
) -> np.ndarray:
    """Distance (in tokens) from every state to the nearest accepting
    state.

    This powers **guaranteed-parse decoding**: the sampler masks any
    token leading to a state whose distance exceeds the remaining budget,
    so a guided generation can never run out of budget mid-JSON.  (vLLM
    has no equivalent — its guided outputs truncate at ``max_tokens`` and
    fail to parse; the reference burns a 3-attempt retry ladder on
    exactly this, bcg_agents.py:708-759.)

    Bellman relaxation over the state SUCCESSOR-SET matrix: the min over
    the vocabulary only depends on which distinct states are reachable in
    one token, so the [states, vocab] table (151936 columns for Qwen) is
    collapsed once into a [states, states] boolean reachability matrix
    and each iteration is a tiny masked min.  (The first version gathered
    over the full vocab table per iteration — 18 s per schema at the
    Qwen vocab; this form is milliseconds.)  Iteration count is the DFA's
    completion diameter (tens for the BCG schemas), not the state count.
    """
    S, V = transitions.shape
    valid = transitions >= 0
    reach = np.zeros((S, S), dtype=bool)
    src, _ = np.nonzero(valid)
    reach[src, transitions[valid]] = True
    dist = np.where(accepting, 0, _UNREACHABLE).astype(np.int64)
    for _ in range(S):
        # cand[s] = 1 + min over successor states t of dist[t]
        d = np.where(reach, dist[None, :], _UNREACHABLE)
        cand = 1 + d.min(axis=1)
        improved = cand < dist
        if not improved.any():
            break
        dist = np.where(improved, cand, dist)
    return np.minimum(dist, _UNREACHABLE).astype(np.int32)


def _load_native() -> Optional[ctypes.CDLL]:
    """Compile-on-first-use the C++ builder into ``build/bcg_tpu_torch``.
    Returns None when no toolchain is available."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    src = os.path.join(_NATIVE_DIR, "token_dfa.cpp")
    so_path = os.path.join(_BUILD_DIR, "libtokendfa.so")
    tmp_path = None
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(src):
            with tempfile.NamedTemporaryFile(
                suffix=".so", dir=_BUILD_DIR, delete=False
            ) as tmp:
                tmp_path = tmp.name
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", tmp_path, src],
                check=True,
                capture_output=True,
            )
            os.replace(tmp_path, so_path)
            tmp_path = None
        lib = ctypes.CDLL(so_path)
        lib.build_token_dfa.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.build_token_dfa.restype = None
        _lib = lib
    except (OSError, subprocess.CalledProcessError):
        _lib = None
    finally:
        if tmp_path is not None:
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
    return _lib


def _build_native(char_dfa: CharDFA, token_bytes: Sequence[bytes]) -> Optional[np.ndarray]:
    lib = _load_native()
    if lib is None:
        return None
    vocab = len(token_bytes)
    flat = np.frombuffer(b"".join(token_bytes), dtype=np.uint8).copy()
    offsets = np.zeros(vocab + 1, dtype=np.int64)
    np.cumsum([len(t) for t in token_bytes], out=offsets[1:])
    trans = np.ascontiguousarray(char_dfa.transitions, dtype=np.int32)
    out = np.empty((char_dfa.num_states, vocab), dtype=np.int32)
    if flat.size == 0:
        flat = np.zeros(1, dtype=np.uint8)  # valid pointer for empty vocab
    lib.build_token_dfa(
        trans.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(char_dfa.num_states),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int32(vocab),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _build_numpy(char_dfa: CharDFA, token_bytes: Sequence[bytes]) -> np.ndarray:
    vocab = len(token_bytes)
    max_len = max((len(t) for t in token_bytes), default=0)
    lens = np.array([len(t) for t in token_bytes], dtype=np.int32)
    padded = np.zeros((vocab, max_len), dtype=np.int32)
    for i, t in enumerate(token_bytes):
        if t:
            padded[i, : len(t)] = np.frombuffer(t, dtype=np.uint8)

    trans = char_dfa.transitions  # [S, 256]
    num_states = char_dfa.num_states
    out = np.empty((num_states, vocab), dtype=np.int32)
    for s in range(num_states):
        cur = np.full(vocab, s, dtype=np.int32)
        for pos in range(max_len):
            active = (lens > pos) & (cur >= 0)
            if not active.any():
                break
            nxt = trans[cur[active], padded[active, pos]]
            cur[active] = nxt
        out[s] = cur
    # Zero-length tokens stay in-state; forbid them outright (a guided
    # decoder must always make progress).
    if (lens == 0).any():
        out[:, lens == 0] = -1
    return out



def digit_token_tables(token_bytes: Sequence[bytes]):
    """Per-token decimal tables for the on-device integer parse
    (:func:`parse_int_values`): ``digit_len[t]`` = number of decimal
    digit characters token t contributes (0 for any token containing a
    non-digit byte — including ``b""`` pads), ``digit_val[t]`` = the
    integer value of those digits.  Built once per tokenizer on the
    host; the byte tokenizer's single-char digit tokens give
    ``digit_len`` in {0, 1}, a trained-BPE vocabulary's multi-digit
    tokens land their full width."""
    vocab = len(token_bytes)
    digit_len = np.zeros(vocab, dtype=np.int32)
    digit_val = np.zeros(vocab, dtype=np.int32)
    for i, t in enumerate(token_bytes):
        if t and all(0x30 <= b <= 0x39 for b in t):
            digit_len[i] = len(t)
            digit_val[i] = int(t.decode("ascii"))
    return digit_len, digit_val


def walk_token_dfa(
    tables,        # [U, S, V] int per-unique-guide transition tables
    dfa_ids,       # [B] int32 row -> unique-guide index
    init_states,   # [B] int32 start states
    out_tokens,    # [B, T] int32 emitted tokens (EOS-filled past the end)
    eos_id: int,
):
    """Walk each row's emitted tokens through its token DFA on the
    device, returning the terminal state per row (int32; -1 once any
    transition was forbidden — the row can never reach accepting,
    matching the host parse failing).  EOS ends the walk: the decode
    loop EOS-fills past each row's end, and EOS itself is a
    sampler-level stop, not a table transition.  Two gathers per
    emitted position and no host read — the decision budgets are tens
    of tokens, so this is noise next to one decode step."""
    import torch

    dfa = dfa_ids.long()
    states = init_states.to(torch.int32)
    for j in range(out_tokens.shape[1]):
        tok = out_tokens[:, j]
        live = (tok != eos_id) & (states >= 0)
        nxt = tables[dfa, states.clamp(min=0).long(), tok.long()].to(torch.int32)
        states = torch.where(live, nxt, states)
    return states


def parse_int_values(
    out_tokens,    # [B, T] int32 emitted tokens (EOS-filled past the end)
    eos_id: int,
    digit_len,     # [V] int32 (digit_token_tables)
    digit_val,     # [V] int32
    final_states,  # [B] int32 terminal DFA states (walk_token_dfa)
    accepting,     # [U, S] bool per-unique-guide accepting table
    dfa_ids,       # [B] int32 row -> unique-guide index
):
    """Parse each row's emitted integer on the device, with no host
    read — the fused round's replacement for the host-side
    ``json.loads``: decimal digits are accumulated positionally (each
    digit token's value scaled by 10^(digits to its right)), guarded by
    the terminal DFA state so a row whose automaton did not reach an
    accepting state parses to -1 (abstain), exactly like a host-side
    JSON failure.  Correct for any integer-valued schema whose NON-digit
    skeleton contains no digit characters (the guided ``{"value": N}``
    schemas) on any tokenizer whose digit-carrying tokens are
    digit-ONLY (:func:`digit_token_tables`: mixed tokens contribute 0
    digits and would surface as a mismatch against the lockstep oracle,
    never silently).  ``digit_len``/``digit_val`` may be host numpy
    tables; they go to ``out_tokens``' device.  A -1 terminal state
    indexes the last state of ``accepting``, as negative indices do in
    the JAX package's gather."""
    import torch

    dev = out_tokens.device
    digit_len = torch.as_tensor(digit_len, device=dev)
    digit_val = torch.as_tensor(digit_val, device=dev)
    accepting = torch.as_tensor(accepting, device=dev)
    # int32 throughout, wrapping where the JAX package's int32 does.
    i32 = torch.int32
    toks = out_tokens.long()
    past_eos = torch.cumsum((toks == eos_id).to(i32), dim=1) > 0
    dl = torch.where(past_eos, 0, digit_len[toks].to(i32))        # [B, T]
    # Digits to the RIGHT of each position: reverse exclusive cumsum.
    suffix = (torch.flip(torch.cumsum(torch.flip(dl, [1]), dim=1), [1]) - dl).to(i32)
    scale = torch.where(dl > 0, torch.pow(torch.full_like(suffix, 10), suffix), 0)
    acc = (digit_val[toks].to(i32) * scale).sum(dim=1, dtype=i32)
    ok = accepting[dfa_ids.long(), final_states.long()] & (dl.sum(dim=1) > 0)
    return torch.where(ok, acc, -1).to(torch.int32)

def build_token_dfa(
    char_dfa: CharDFA,
    token_bytes: Sequence[bytes],
    force_numpy: bool = False,
) -> TokenDFA:
    transitions = None
    if not force_numpy:
        transitions = _build_native(char_dfa, token_bytes)
    if transitions is None:
        transitions = _build_numpy(char_dfa, token_bytes)
    else:
        # Native path walks zero-length tokens as no-ops; forbid them.
        lens = np.array([len(t) for t in token_bytes], dtype=np.int32)
        if (lens == 0).any():
            transitions[:, lens == 0] = -1
    return TokenDFA(
        transitions=transitions,
        accepting=char_dfa.accepting.copy(),
        start=char_dfa.start,
        dist=completion_paths(transitions, char_dfa.accepting),
    )
