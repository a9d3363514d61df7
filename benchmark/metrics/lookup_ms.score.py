"""Device milliseconds a traced scoring batch keeps the card busy with
what the port's span cffm.lookup launched (the prefix and big-field
gathers and their casts to the compute dtype), within the cffm.forward
spans (`benchmark/spans.py`)."""
from benchmark import spans


def read(run):
    return spans.busy_ms(run, "cffm.forward", "cffm.lookup")
