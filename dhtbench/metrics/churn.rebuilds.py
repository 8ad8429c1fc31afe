"""churn.rebuilds: calls per thousand whose view was a newly built base:
the program's ``dht_table_compactions_total`` over the window (every
rebuild that folds pending churn into a new sorted base counts once),
per thousand calls."""


def read(run):
    w = run.window
    n = w.program.get("dht_table_compactions_total")
    return 1e3 * n / len(w.calls) if n is not None and w.calls else None
