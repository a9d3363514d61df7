"""Percent of the streamed sparse update's slots that hold a row in the
traced training steps: the distinct rows kernel 3 found (the port's
counter sparse.distinct_rows, summed on the device) over the slots it
was sized to (sparse.slots). None from a port without the counters, or
unless the update took the streamed route once a traced step."""
from benchmark import spans


def read(run):
    counts = spans.counts()
    if counts is None or not run.items or counts.get("sparse.streamed") != len(run.items):
        return None
    if not counts.get("sparse.slots") or "sparse.distinct_rows" not in counts:
        return None
    return 100.0 * counts["sparse.distinct_rows"] / counts["sparse.slots"]
