"""BAD: mutable default arguments."""


def append_to(x, acc=[]):          # BCG-MUT-DEFAULT
    acc.append(x)
    return acc


def tally(key, counts={}):         # BCG-MUT-DEFAULT
    counts[key] = counts.get(key, 0) + 1
    return counts
