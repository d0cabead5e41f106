"""Clean twin of bad_lock_order.py: both thread roots acquire the two
locks in the SAME order (cond, then device lock), so the acquisition
graph has one edge and no cycle — a consistent global lock order is the
fix for an inversion."""

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
        with self._cond:
            with self._device_lock:
                self._jobs.pop()

    def _supervise(self):
        # same order as _dispatch: no inversion
        with self._cond:
            with self._device_lock:
                self._jobs.append(None)
