"""Process start to window start: imports, the kernel build (first run
of a checkout only), the weights' draw, the engine's boot and the warm-up
rounds."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(run):
    return run.setup_s
