"""Device milliseconds a traced training step keeps the card busy with
what the port's span cffm.dense_update launched (the schedule factor,
the dense chain's update and its in-place adds), within the cffm.step
spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.step", "cffm.dense_update")
