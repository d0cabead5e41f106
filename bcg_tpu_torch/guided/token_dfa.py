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
