"""Seconds from the process's start to the window's: imports, the card's
context, the kernels' build or load, weights and batches from the seed,
the checked steps and the warm-up."""


def read(record):
    return record["setup_s"]
