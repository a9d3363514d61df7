"""Device milliseconds a traced scoring batch keeps the card busy with
what the port's span cffm.conv_tail launched (the conv tail after kernel
1: one launch of its kernel on a forward without a gradient, else the
eager passes), within the cffm.forward spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.forward", "cffm.conv_tail")
