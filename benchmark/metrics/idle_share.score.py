"""Percent of the traced scoring batches' stretch in which the card ran nothing."""
from benchmark import readers


def read(run):
    return readers.idle_share(run)
