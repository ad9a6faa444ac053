"""Host ms a step in the SS geometry: the program's ``ss.pseudo_gt``
(undistortion and triangulation) and ``ss.targets`` (reprojection, crop
affines, dual-crop remap, integral targets) spans
(``core/self_supervised.py``), over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("ss.pseudo_gt", "ss.targets"), "host_ms")
