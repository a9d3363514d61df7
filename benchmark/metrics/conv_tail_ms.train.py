"""Device milliseconds a traced training step keeps the card busy with
what the port's span cffm.conv_tail launched (the conv tail's forward
after kernel 1; a step takes gradients, so the eager passes), within the
cffm.step spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.step", "cffm.conv_tail")
