"""Traffic of kind ``eval``: crops with their boxes' centres and scales, as
the Human3.6M evaluation loader ships them.

Mix parameters: ``batch``, ``pool`` (distinct batches, cycled),
``flip_pairs`` (read by the entry).
"""

from __future__ import annotations

from benchmark.generate import crops, uniform


def samples_per_batch(mix: dict) -> int:
    return int(mix["batch"])


def pool(mix: dict, arch: dict, g, device) -> list[dict]:
    n = int(mix["batch"])
    w, h = arch["image_size"]
    return [{"input": crops(g, (n, h, w, 3), device),
             "center": uniform(g, (n, 2), 200, 800, device),
             "scale": uniform(g, (n, 2), 0.8, 1.2, device)}
            for _ in range(int(mix["pool"]))]
