"""Percent of the scatter sparse update's slots that hold a row in the
traced training steps: the rows it wrote (the port's counter
sparse.scatter_rows) over the slots its segment sums were sized to
(sparse.scatter_slots). None from a port without the counters, or
unless the update took the scatter route once a traced step
(sparse.scatter)."""
from benchmark import spans


def read(run):
    counts = spans.counts()
    if counts is None or not run.items or counts.get("sparse.scatter") != len(run.items):
        return None
    if not counts.get("sparse.scatter_slots") or "sparse.scatter_rows" not in counts:
        return None
    return 100.0 * counts["sparse.scatter_rows"] / counts["sparse.scatter_slots"]
