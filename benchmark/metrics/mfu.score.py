"""The scoring window's model FLOPs (the forward of each candidate) over
the card's bf16 dense peak."""
from benchmark import readers


def read(run):
    return readers.mfu(run)
