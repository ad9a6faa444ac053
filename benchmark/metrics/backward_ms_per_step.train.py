"""Device ms a step in the backward: the program's ``train.backward``
span (``core/steps.py::optimizer_step``), event to event on the step's
stream, over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("train.backward",), "device_ms")
