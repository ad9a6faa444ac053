"""Traffic of kind ``fs``: single-view crops with 2D joints in crop pixels
and 3D joints in mm, as the fully supervised 3D loader ships them.

Mix parameters: ``batch``, ``pool`` (distinct batches, cycled),
``depth_mm`` (the joints' depth about the root), ``vis_share`` (the
share of visible joints).
"""

from __future__ import annotations

import torch

from benchmark.generate import crops, uniform


def samples_per_batch(mix: dict) -> int:
    return int(mix["batch"])


def pool(mix: dict, arch: dict, g, device) -> list[dict]:
    n, j = int(mix["batch"]), arch["num_joints"]
    w, h = arch["image_size"]
    out = []
    for _ in range(int(mix["pool"])):
        xy = torch.stack([uniform(g, (n, j), 0, w, device),
                          uniform(g, (n, j), 0, h, device)], -1)
        z = uniform(g, (n, j), -mix["depth_mm"], mix["depth_mm"], device)
        root = uniform(g, (n, 1, 3), -500, 500, device) \
            + torch.tensor([0.0, 0.0, 4500.0], device=device)
        offsets = torch.cat([torch.zeros((n, j, 2), device=device),
                             z[..., None]], -1)
        offsets[:, 0] = 0.0
        vis = (torch.rand((n, j), generator=g, device=device)
               < mix["vis_share"]).float()
        out.append({"input": crops(g, (n, h, w, 3), device),
                    "joints": xy, "joints_vis": vis,
                    "joints_3d": root + offsets})
    return out
