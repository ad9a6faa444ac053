"""Host ms a batch inside the program's eval step: its ``eval.step``
span (``core/steps.py::make_eval_step``), without the copy of the
predictions to the host, over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("eval.step",), "host_ms")
