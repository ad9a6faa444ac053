"""Device ms a step in batch-norm kernels, forward and backward, by the
frozen kernel-name table, over the profiled stretch."""
from benchmark.readers import group_s_per_call


def read(record):
    s = group_s_per_call(record, "batch_norm")
    return None if s is None else 1e3 * s
