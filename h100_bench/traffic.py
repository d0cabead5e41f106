"""The one traffic generator: closed-loop game clients over the program's
serving tier, driven by a traffic file's numbers.  Every game calls one
``ServingEngine`` (at the program's default linger), which merges whatever
calls coincide into one engine call.

A traffic file (``h100_bench/traffic/<name>.json``) sets:

* ``games`` concurrent games of ``honest`` + ``byzantine`` agents, with
  ``max_rounds``, and of those games the first ``greedy_games`` decide and
  vote at temperature 0 (the rows the logit comparison reads); the others
  sample at ``temperature_decide`` / ``temperature_vote``; every row within
  ``max_tokens_decide`` / ``max_tokens_vote``;
* ``warmup_rounds`` of every game in set-up; ``check_tokens``: the served
  tokens of greedy rows the comparison takes at the least.

Each client plays one game at a time, a round at a time: the round's
decide and vote calls wait for their own replies.  A game that ends is
replaced by a new one whose seed comes from the run's seed and the
client's index.  In the window a client starts a round only while the
window is open (elapsed < ``--seconds``), and the window closes when the
last round started inside it ends: only whole rounds count.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

TRAFFIC_KEYS = {
    "games", "honest", "byzantine", "greedy_games", "max_rounds", "warmup_rounds",
    "temperature_decide", "temperature_vote", "max_tokens_decide", "max_tokens_vote",
    "check_tokens", "why",
}


def check_traffic(trf: Dict) -> Dict:
    unknown = set(trf) - TRAFFIC_KEYS
    missing = TRAFFIC_KEYS - {"why"} - set(trf)
    if unknown or missing:
        raise ValueError(f"traffic file: unknown keys {sorted(unknown)}, missing {sorted(missing)}")
    if not 0 <= trf["greedy_games"] <= trf["games"]:
        raise ValueError("greedy_games must be between 0 and games")
    return trf


def derived_seed(seed: int, *salt) -> int:
    """A 63-bit seed drawn from the run's seed and a salt (string seeds
    of ``random.Random`` hash by SHA-512: the same on every machine)."""
    return random.Random(":".join(str(s) for s in (seed,) + salt)).getrandbits(63)


# ---------------------------------------------------------------- recorder

@dataclass
class Row:
    system: str
    user: Any
    schema: Dict
    temperature: float
    budget: int
    text: Optional[str]
    result: Any


@dataclass
class Call:
    t0: float
    t1: float
    rows: List[Row] = field(default_factory=list)


def _per_row(value, n: int, kind):
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{len(value)} settings for {n} rows")
        return [kind(v) for v in value]
    return [kind(value)] * n


class Recorder:
    """Records every guided call of the engine: its rows' prompts,
    schemas, temperatures and budgets, the text each row was served and
    what the engine returned, with the call's host times.

    The engine's ``batch_generate_json`` is wrapped on the instance, and
    so is its ``_run_guided``, whose outermost call returns the served
    texts in row order (the engine parses them into the values it
    returns; the comparison judges the texts)."""

    def __init__(self, engine):
        self.calls: List[Call] = []
        self._local = threading.local()
        self._lock = threading.Lock()
        inner_call = engine.batch_generate_json
        inner_guided = engine._run_guided
        local = self._local

        def run_guided(parts, schemas, temperature, max_tokens, top_p=1.0):
            depth = getattr(local, "depth", 0)
            local.depth = depth + 1
            try:
                texts = inner_guided(parts, schemas, temperature, max_tokens, top_p)
            finally:
                local.depth = depth
            if depth == 0:
                local.texts = list(texts)
            return texts

        def batch_generate_json(prompts, temperature=0.8, max_tokens=512):
            local.texts = None
            t0 = time.perf_counter()
            results = inner_call(prompts, temperature, max_tokens)
            t1 = time.perf_counter()
            n = len(prompts)
            texts = local.texts if local.texts is not None else [None] * n
            temps = _per_row(temperature, n, float)
            budgets = _per_row(max_tokens, n, int)
            call = Call(t0, t1, [Row(s, u, sc, t, b, x, r) for (s, u, sc), t, b, x, r
                                 in zip(prompts, temps, budgets, texts, results)])
            with self._lock:
                self.calls.append(call)
            return results

        engine.batch_generate_json = batch_generate_json
        engine._run_guided = run_guided

    def since(self, t: float) -> List[Call]:
        with self._lock:
            return [c for c in self.calls if c.t0 >= t]


# ---------------------------------------------------------------- clients

class Client:
    """One closed-loop game client: a game at a time, a round at a time."""

    def __init__(self, index: int, trf: Dict, engine_config, seed: int):
        self.index = index
        self.trf = trf
        self.engine_config = engine_config
        self.seed = seed
        self.greedy = index < trf["greedy_games"]
        self.sim = None
        self.games = 0
        self.rounds = 0

    def _config(self):
        from bcg_tpu_torch.config import BCGConfig, GameConfig, LLMConfig, MetricsConfig

        t = self.trf
        llm = LLMConfig(
            temperature_decide=0.0 if self.greedy else t["temperature_decide"],
            temperature_vote=0.0 if self.greedy else t["temperature_vote"],
            max_tokens_decide=t["max_tokens_decide"], max_tokens_vote=t["max_tokens_vote"])
        game = GameConfig(num_honest=t["honest"], num_byzantine=t["byzantine"],
                          max_rounds=t["max_rounds"],
                          seed=derived_seed(self.seed, "game", self.index, self.games))
        return BCGConfig(game=game, engine=self.engine_config, llm=llm,
                         metrics=MetricsConfig(save_results=False))

    def play_round(self, engine) -> None:
        from bcg_tpu_torch.runtime.orchestrator import BCGSimulation

        if self.sim is None or self.sim.game.game_over:
            self.sim = BCGSimulation(self._config(), engine=engine)
            self.games += 1
        self.sim.run_round()
        self.rounds += 1

    @property
    def agents(self) -> int:
        return self.trf["honest"] + self.trf["byzantine"]


class Driver:
    """The cell's games over one ``ServingEngine`` over the engine."""

    def __init__(self, engine, trf: Dict, engine_config, seed: int):
        from bcg_tpu_torch.serve import ServingEngine

        self.trf = trf
        self.clients = [Client(i, trf, engine_config, seed) for i in range(trf["games"])]
        self.serving = ServingEngine(engine)

    def scheduler_counts(self) -> Dict[str, int]:
        snap = self.serving.stats()
        return {k: int(snap[k]) for k in ("dispatches", "dispatched_rows", "failed",
                                          "merged_dispatches")}

    def play(self, rounds: Optional[int] = None, seconds: Optional[float] = None
             ) -> Tuple[int, int]:
        """Every client plays ``rounds`` rounds, or rounds while ``seconds``
        have not passed since the call began.  Returns (rounds, decisions)
        played: a decide and a vote for each agent of each round."""
        if rounds == 0:
            return 0, 0
        t0 = time.perf_counter()
        before = [(c.rounds, c.agents) for c in self.clients]

        def loop(client: Client) -> None:
            done = 0
            while True:
                client.play_round(self.serving)
                done += 1
                if rounds is not None and done >= rounds:
                    return
                if seconds is not None and time.perf_counter() - t0 >= seconds:
                    return

        self._threads([lambda c=c: loop(c) for c in self.clients])
        played = sum(c.rounds - r for c, (r, _) in zip(self.clients, before))
        decisions = sum(2 * a * (c.rounds - r) for c, (r, a) in zip(self.clients, before))
        return played, decisions

    @staticmethod
    def _threads(fns) -> None:
        errors: List[BaseException] = []
        start = threading.Barrier(len(fns))

        def run(fn):
            try:
                start.wait()
                fn()
            except BaseException as e:  # re-raised in the caller's thread below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(fn,), name=f"bench-client-{i}")
                   for i, fn in enumerate(fns)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]

    def close(self) -> None:
        if self.serving is not None:
            self.serving.shutdown()
            self.serving = None
