"""Device milliseconds a traced training step keeps the card busy with
what the port's span cffm.conv_tail_bwd launched (the conv tail's backward
kernel, which autograd runs on its device thread), within the cffm.step
spans (`benchmark/spans.py`). None from a port without the span."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.step", "cffm.conv_tail_bwd")
