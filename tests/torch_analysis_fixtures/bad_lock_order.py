"""Seeded BCG-LOCK-ORDER violation: the PR-15 device-lock-swap shape.

The dispatch thread nests the device lock under the queue condition;
the watchdog takes the device lock first and then wants the condition —
a two-lock inversion across two thread roots, i.e. the deadlock the
real scheduler avoids by REPLACING the device lock object instead of
ever nesting it under ``_cond``.  Exactly one cycle is seeded.
"""

import threading


class Pipeline:
    def __init__(self):
        self._cond = threading.Condition()
        self._device_lock = threading.Lock()
        self._jobs = []
        threading.Thread(
            target=self._dispatch, name="fx-dispatch", daemon=True
        ).start()
        threading.Thread(
            target=self._supervise, name="fx-watchdog", daemon=True
        ).start()

    def _dispatch(self):
        # queue cond -> device lock
        with self._cond:
            with self._device_lock:
                self._jobs.pop()

    def _supervise(self):
        # device lock -> queue cond: the inversion
        with self._device_lock:
            with self._cond:
                self._jobs.append(None)
