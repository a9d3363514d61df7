"""Percent of the traced training steps in which the card ran nothing."""
from benchmark import readers


def read(run):
    return readers.idle_share(run)
