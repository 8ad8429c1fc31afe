"""table.launch_ms: host ms per call in ``NodeTable.find_closest_launch``
(the benchmark's span): the view, the targets' upload and the enqueue of
the lookup chain."""


def read(run):
    s = run.window.spans.get("launch")
    return 1e3 * sum(s) / len(s) if s else None
