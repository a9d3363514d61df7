"""Device milliseconds a traced training step keeps the card busy with
what the port's span cffm.sparse_update launched (the sort, gathers and
kernels 3-4 of the big fields, the prefix's gradient and its dense
row-wise apply), within the cffm.step spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.step", "cffm.sparse_update")
