"""BAD: broad excepts that swallow silently."""


def f():
    try:
        risky()
    except Exception:              # BCG-EXCEPT-BROAD
        pass


def g():
    try:
        risky()
    except:                        # BCG-EXCEPT-BROAD (bare)
        return None
