"""The training window's model FLOPs (3x the forward an example) over
the card's bf16 dense peak."""
from benchmark import readers


def read(run):
    return readers.mfu(run)
