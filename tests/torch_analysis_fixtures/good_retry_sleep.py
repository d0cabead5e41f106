"""Clean idioms BCG-RETRY-SLEEP must stay quiet on: derived delays in
loops, constant sleeps outside loops, and loop-adjacent closures."""

import time


def backoff_retry(fn):
    delay = 0.05
    for _ in range(5):
        try:
            return fn()
        except RuntimeError:
            time.sleep(delay)  # derived: grows per attempt
            delay = min(delay * 2, 1.0)
    raise RuntimeError("gave up")


def jittered_poll(check, rng):
    while not check():
        time.sleep(0.05 * (1.0 + rng.random()))  # derived: jittered


def honor_retry_after(fn):
    while True:
        try:
            return fn()
        except TimeoutError as e:
            time.sleep(getattr(e, "retry_after_s", 0.1))  # server-supplied


def one_shot_settle():
    time.sleep(0.2)  # constant, but not in a loop


def build_wait_closures():
    waiters = []
    for _ in range(3):
        # The sleep is inside a nested function body, not the loop's
        # execution path — defining it per iteration is not polling.
        def waiter():
            time.sleep(0.1)

        waiters.append(waiter)
    return waiters
