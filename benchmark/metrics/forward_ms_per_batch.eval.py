"""Device ms a batch in the eval step's two forwards and the flip-back:
the program's ``eval.forward`` and ``eval.flip`` spans
(``core/steps.py::make_eval_step``), event to event on the step's
stream, over the profiled stretch."""
from benchmark.spans import per_step


def read(record):
    return per_step(record, ("eval.forward", "eval.flip"), "device_ms")
