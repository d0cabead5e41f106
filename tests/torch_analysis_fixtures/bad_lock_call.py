"""Seeded BCG-LOCK-CALL violations: engine calls while holding a
scheduler/collective lock (3 findings: with-lock engine call, with-cond
engine call, engine call inside a *_locked helper)."""

import threading


class BadProxy:
    def __init__(self, engine):
        self._engine = engine
        self._lock = threading.Lock()
        self._cond = threading.Condition()
        self._pending = []

    def submit(self, prompts):
        with self._lock:
            return self._engine.batch_generate_json(prompts)  # finding

    def submit_text(self, prompts):
        with self._cond:
            return self._engine.generate(prompts)  # finding

    def _dispatch_all_locked(self):
        batch = list(self._pending)
        self._pending = []
        return self._engine.batch_generate(batch)  # finding
