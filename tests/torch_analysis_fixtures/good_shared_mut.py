"""Clean twin of bad_shared_mut.py: the same two thread roots mutate
the attribute, but every mutation site holds the one shared lock — a
common guard across all writers silences the rule."""

import threading


class Tally:
    def __init__(self):
        self._lock = threading.Lock()
        self.total = 0
        threading.Thread(
            target=self._drain, name="fx-drain", daemon=True
        ).start()
        threading.Thread(
            target=self._refill, name="fx-refill", daemon=True
        ).start()

    def _drain(self):
        with self._lock:
            self.total -= 1

    def _refill(self):
        with self._lock:
            self.total += 1
