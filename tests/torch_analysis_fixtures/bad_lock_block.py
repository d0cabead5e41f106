"""Seeded BCG-LOCK-BLOCK violations: blocking work performed while a
lock is held — directly (sleep, file I/O) and through a call chain the
interprocedural pass resolves.  Three violations exactly."""

import threading
import time


class Flusher:
    def __init__(self):
        self._lock = threading.Lock()
        self._buf = []
        threading.Thread(
            target=self._loop, name="fx-flush", daemon=True
        ).start()

    def _loop(self):
        with self._lock:
            time.sleep(0.5)  # 1: sleep under the lock
            with open("/tmp/fx_out", "w") as fh:  # 2: file I/O under it
                fh.write("x")
            self._write_all()  # 3: transitive file I/O under it

    def _write_all(self):
        with open("/tmp/fx_out2", "w") as fh:
            fh.write("".join(self._buf))
