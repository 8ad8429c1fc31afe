"""table.consume_ms: host ms per call in ``PendingLookup.consume`` (the
benchmark's span): the wait for the device, the repair of uncertified
rows and the copies back."""


def read(run):
    s = run.window.spans.get("consume")
    return 1e3 * sum(s) / len(s) if s else None
