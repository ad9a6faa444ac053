"""Samples whose predictions reached the host in the window, over the
whole window (host clock)."""
from benchmark.readers import rate


def read(record):
    return rate(record)
