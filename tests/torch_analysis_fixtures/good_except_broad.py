"""GOOD: narrow types, re-raise, logging, or exception use."""
import logging

log = logging.getLogger(__name__)


def f():
    try:
        risky()
    except ValueError:             # narrow: fine
        pass


def g():
    try:
        risky()
    except Exception as exc:       # reported: fine
        log.warning("risky failed: %s", exc)
        raise
