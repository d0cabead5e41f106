"""Run logging.

The reference tees output through a module-global file handle and shadows
the ``print`` builtin module-wide (``bcg_agents.py:62-69``, ``main.py:53-64``).
Here logging is an injectable object: always written to the run log file,
echoed to the console per verbosity, no global state.
"""

from __future__ import annotations

import os
from typing import IO, Optional

from bcg_tpu_torch.runtime.envflags import get_bool


class RunLogger:
    """Tee logger: every message goes to the log file (if any); console
    output is controlled per call."""

    def __init__(
        self, log_path: Optional[str] = None, verbose: bool = False, mode: str = "w"
    ):
        # VERBOSE=1 env forces verbosity (reference convention:
        # vllm_agent.py:31, byzantine_consensus.py:17, main.py:1108).
        self.verbose = verbose or get_bool("VERBOSE")
        self.log_path = log_path
        self._fh: Optional[IO] = None
        if log_path:
            os.makedirs(os.path.dirname(log_path), exist_ok=True)
            self._fh = open(log_path, mode, buffering=1)  # line buffered

    def log(self, message: str, level: str = "INFO") -> None:
        """File always (prefixed), console when verbose
        (reference main.py:164-174)."""
        if self._fh:
            self._fh.write(f"[{level}] {message}\n")
        if self.verbose:
            print(message)

    def echo(self, message: str) -> None:
        """Console always + file (reference tee_print, main.py:57-64)."""
        print(message)
        if self._fh:
            self._fh.write(message + "\n")

    def debug(self, message: str) -> None:
        """File always, console only when verbose
        (reference verbose_print, bcg_agents.py:72-79)."""
        if self._fh:
            self._fh.write(message + "\n")
        if self.verbose:
            print(message)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
