"""search.kernels_per_round: device kernels of the traced waves over
their rounds (one ``search.select`` span of the program per round)."""


def read(run):
    t = run.trace
    rounds = t.count("search.select") if t is not None else 0
    return len(t.kernels) / rounds if rounds and t.kernels else None
