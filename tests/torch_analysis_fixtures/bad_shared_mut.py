"""Seeded BCG-SHARED-MUT violation: one attribute mutated from two
distinct thread roots with no lock held at either site.  The lock
exists on the object — it just isn't used — so the finding is about the
unguarded mutation sites, not a missing lock object.  One violation
exactly (the rule reports per attribute, not per site)."""

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
        self.total -= 1  # unguarded, thread root 1

    def _refill(self):
        self.total += 1  # unguarded, thread root 2
