"""lookup_p95_ms: the 95th percentile (nearest rank) over every lookup
the window completed, from the handoff of its batch to the program to its
result on the host.  The lookups of a batch share its time; a lookup that
failed counts as missing, that is as slower than every other."""

import math


def read(run):
    calls = run.window.calls
    total = sum(c[1] for c in calls)
    if not total:
        return None
    rank = math.ceil(0.95 * total)
    seen = 0
    for seconds, lookups, ok in sorted(calls):
        seen += ok
        if seen >= rank:
            return seconds * 1e3
    return None
