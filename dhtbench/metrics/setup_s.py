"""setup_s: process start to the first timed call: imports, the card's
context, the kernels' build on a checkout's first run, the table made
from the seed, and the warm-up calls of the cell's shapes."""


def read(run):
    return run.setup_s
