"""Device milliseconds a traced training step keeps the card busy with
what the port's span cffm.lookup launched (the prefix and big-field
gathers and their casts to the compute dtype), within the cffm.step
spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.step", "cffm.lookup")
