"""Clean idioms BCG-TIME-WALL must not flag: monotonic durations and
bare wall-clock timestamps (no arithmetic at the call site)."""
import time


def stamp_result(result):
    # Bare timestamp — stored, not subtracted: wall clock is CORRECT here.
    result["recorded_at"] = time.time()
    return result


def elapsed_since(t0):
    return time.perf_counter() - t0


def poll_until_done(check):
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        if check():
            return True
    return False
