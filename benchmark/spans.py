"""What the readers of the program's own spans share: the aggregate of
``epipolarpose_tpu_torch.telemetry`` over the profiled stretch, in which
the program's spans record (they record only while ``torch.profiler``
records), per top-level step span."""

from __future__ import annotations

# the top-level spans of one step, by the entry's kind
STEP_SPANS = {"train": ("train.step", "ss.step"), "eval": ("eval.step",)}


def per_step(record: dict, names: tuple, field: str) -> float | None:
    """The sum of ``field`` (``device_ms`` or ``host_ms``) over the spans
    ``names``, per step span recorded; None without a trace, with a
    program that has no spans, or where one of them was not recorded."""
    if not record.get("trace"):
        return None
    try:
        from epipolarpose_tpu_torch import telemetry
    except ImportError:           # a program without spans of its own
        return None
    spans = telemetry.snapshot()["spans"]
    steps = sum(spans[n]["calls"] for n in STEP_SPANS[record["kind"]]
                if n in spans)
    values = [spans[n][field] if n in spans else None for n in names]
    if not steps or None in values:
        return None
    return sum(values) / steps
