"""lookups_per_s: the lookups the window completed over its seconds.  A
lookup is one closest-node resolve, or one iterative search that
converged; the window runs from its first handoff to its last result on
the host."""


def read(run):
    w = run.window
    return w.ok / w.seconds if w.calls and w.seconds > 0 else None
