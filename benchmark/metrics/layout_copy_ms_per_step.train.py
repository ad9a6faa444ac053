"""Device ms a step in NCHW/NHWC transpose kernels, by the frozen
kernel-name table, over the profiled stretch."""
from benchmark.readers import group_s_per_call


def read(record):
    s = group_s_per_call(record, "layout_copy")
    return None if s is None else 1e3 * s
