"""Clean idiom for BCG-LOCK-CALL: queue state is copied under the lock,
the engine call runs after it is released."""

import threading


class GoodProxy:
    def __init__(self, engine):
        self._engine = engine
        self._cond = threading.Condition()
        self._pending = []

    def submit(self, prompts):
        with self._cond:
            self._pending.append(prompts)
            batch = [row for call in self._pending for row in call]
            self._pending = []
        return self._engine.batch_generate_json(batch)

    def upload(self, torch, table, device):
        with self._cond:
            pending = list(self._pending)
        device_table = torch.as_tensor(pending or table).to(device)
        with self._cond:
            self._table = device_table
        return device_table

    def acquire_via_engine(self):
        # The lock-ACQUIRING call runs before the lock is held — an
        # engine-owned lock accessor must not be flagged.
        with self._engine.lock():
            self._pending.clear()
