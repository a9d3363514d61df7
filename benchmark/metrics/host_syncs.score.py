"""Host synchronizes a traced scoring batch: the trace's host records of
a stream, device or event synchronize, or a synchronous cudaMemcpy, that
start inside one of the port's cffm.forward spans, over the batches
(`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.syncs(run, "cffm.forward")
