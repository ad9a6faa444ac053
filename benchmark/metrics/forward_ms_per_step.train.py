"""Device ms a step in the student's forward, decode and loss: the
program's ``train.forward`` span (``core/steps.py::integral_update``),
event to event on the step's stream, over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("train.forward",), "device_ms")
