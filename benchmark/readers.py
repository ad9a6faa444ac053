"""What the metric readers share: device time by kernel group from the
profiled stretch, per call."""

from __future__ import annotations

import json
import pathlib

GROUPS = json.loads((pathlib.Path(__file__).resolve().parent
                     / "kernel_groups.json").read_text())


def group_s_per_call(record: dict, group: str) -> float | None:
    """Device seconds a call of the kernels whose names hold one of the
    group's patterns; None without a trace or where none ran."""
    trace = record.get("trace")
    if not trace:
        return None
    pats = GROUPS[group]
    total = sum(t for name, (t, _) in trace["kernels"].items()
                if any(p in name.lower() for p in pats))
    return total / trace["calls"] if total > 0 else None


def rate(record: dict) -> float:
    """Samples a second over the whole window."""
    return record["calls"] * record["samples"] / record["window_s"]


def heatmap_shape(record: dict) -> tuple:
    a = record["arch"]
    w, h = a["heatmap_size"]
    return (record["samples"], a["num_joints"], a["depth_dim"], h, w,
            record["dtype"])
