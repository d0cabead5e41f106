"""Seeded BCG-TIME-WALL violations: wall-clock durations (3 findings)."""
import time


def elapsed_since(t0):
    return time.time() - t0  # finding 1: duration subtraction


def poll_until_done(check):
    deadline = time.time() + 5.0  # finding 2: deadline accumulation
    while time.time() < deadline:  # finding 3: deadline comparison
        if check():
            return True
    return False
