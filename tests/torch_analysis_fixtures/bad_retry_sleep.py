"""Seeded violations for BCG-RETRY-SLEEP: constant-interval sleeps
inside retry/poll loops (3 findings)."""

import time
from time import sleep


def poll_until_ready(check):
    while not check():
        time.sleep(0.5)  # finding: fixed-cadence poll


def retry_flaky(fn):
    for _ in range(3):
        try:
            return fn()
        except RuntimeError:
            sleep(1)  # finding: constant retry interval (bare import)
    raise RuntimeError("gave up")


def nested_in_branch(check):
    while True:
        if check():
            return
        time.sleep(0.01)  # finding: loop-enclosed even through the if
