"""Clean twin of bad_lock_block.py: state is copied under the lock and
every blocking operation (file I/O, sleep) happens after release — the
serve/scheduler.py dispatch shape."""

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
            batch = list(self._buf)
            self._buf.clear()
        self._write_all(batch)
        time.sleep(0.5)

    def _write_all(self, batch):
        with open("/tmp/fx_out", "w") as fh:
            fh.write("".join(batch))
