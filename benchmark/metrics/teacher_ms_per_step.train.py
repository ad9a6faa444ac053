"""Device ms a step in the SS teacher's forward and decode: the
program's ``ss.teacher`` span (``core/self_supervised.py::teacher_detect``),
event to event on the step's stream, over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("ss.teacher",), "device_ms")
