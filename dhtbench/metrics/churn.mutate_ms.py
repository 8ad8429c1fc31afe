"""churn.mutate_ms: host ms per round of churn (the benchmark's span):
the round's ``NodeTable.bulk_load`` of fresh ids and its ``remove``
calls."""


def read(run):
    s = run.window.spans.get("mutate")
    return 1e3 * sum(s) / len(s) if s else None
