"""Crops of every step completed in the window over the whole window,
which ends in a synchronize (host clock)."""
from benchmark.readers import rate


def read(record):
    return rate(record)
