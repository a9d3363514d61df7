"""Host synchronizes a traced training step: the trace's host records of
a stream, device or event synchronize, or a synchronous cudaMemcpy, that
start inside one of the port's cffm.step spans, over the steps
(`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.syncs(run, "cffm.step")
