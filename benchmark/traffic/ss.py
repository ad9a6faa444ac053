"""Traffic of kind ``ss``: G groups of V views of one skeleton each, seen by
a Human3.6M-like rig of V distorted cameras on a circle: the boxes around
the projected joints, uint8 crops, and the dual crop (a seeded scale,
rotation and flip of each box), as the self-supervised loader ships them.

Mix parameters: ``groups``, ``views``, ``pool`` (distinct batches,
cycled), ``pose_noise_mm``, ``scale_factor``, ``rot_factor`` (degrees),
``flip_pairs`` (read by the entry).
"""

from __future__ import annotations

import math

import torch

from benchmark.generate import crops, uniform
from benchmark.reference import geometry

# Human3.6M's 17 joints (root, right leg, left leg, spine, thorax, neck,
# head, left arm, right arm) relative to the root, mm, z up
SKELETON = ((0, 0, 0), (-130, 0, 0), (-130, 0, -450), (-130, 0, -880),
            (130, 0, 0), (130, 0, -450), (130, 0, -880), (0, 0, 230),
            (0, 0, 480), (0, 30, 580), (0, 0, 700), (170, 0, 480),
            (190, 0, 200), (200, 0, -50), (-170, 0, 480), (-190, 0, 200),
            (-200, 0, -50))


def samples_per_batch(mix: dict) -> int:
    return int(mix["groups"]) * int(mix["views"])


def rig(views: int, g, device) -> dict:
    """V cameras on a 4.5 m circle, 1.5 m up, looking at the origin; focal
    1145 px, principal point (500, 500), Human3.6M-sized distortion."""
    out = {k: [] for k in "RTfckp"}
    for v in range(views):
        ang = (2 * math.pi * v / views
               + float(uniform(g, (), -0.1, 0.1, device)))
        t = torch.tensor([4500 * math.cos(ang), 4500 * math.sin(ang), 1500.0])
        z = -t / t.norm()
        x = torch.linalg.cross(torch.tensor([0.0, 0.0, 1.0]), z)
        x = x / x.norm()
        y = torch.linalg.cross(z, x)
        out["R"].append(torch.stack([x, y, z]))
        out["T"].append(t)
        out["f"].append(torch.tensor([1145.0, 1145.0]))
        out["c"].append(torch.tensor([500.0, 500.0]))
        out["k"].append(torch.tensor([-0.2, 0.24, -0.002]))
        out["p"].append(torch.tensor([0.001, -0.0005]))
    return {k: torch.stack(v).to(device) for k, v in out.items()}


def pool(mix: dict, arch: dict, g, device) -> list[dict]:
    groups, views = int(mix["groups"]), int(mix["views"])
    j = arch["num_joints"]
    w, h = arch["image_size"]
    cams = rig(views, g, device)
    cams = {k: v[None].expand((groups,) + v.shape).contiguous()
            for k, v in cams.items()}
    skeleton = torch.tensor(SKELETON, dtype=torch.float32, device=device)
    out = []
    for _ in range(int(mix["pool"])):
        yaw = uniform(g, (groups,), 0, 2 * math.pi, device)
        c, s = torch.cos(yaw), torch.sin(yaw)
        zero, one = torch.zeros_like(c), torch.ones_like(c)
        turn = torch.stack([torch.stack([c, -s, zero], -1),
                            torch.stack([s, c, zero], -1),
                            torch.stack([zero, zero, one], -1)], -2)
        pose = skeleton + mix["pose_noise_mm"] * torch.randn(
            (groups, j, 3), generator=g, device=device)
        root = torch.stack([uniform(g, (groups,), -150, 150, device),
                            uniform(g, (groups,), -150, 150, device),
                            uniform(g, (groups,), 600, 1000, device)], -1)
        world = torch.einsum("gij,gnj->gni", turn, pose) + root[:, None]
        px = geometry.project(world[:, None], cams)           # (G, V, J, 2)
        center = px.mean(2)
        extent = (px - center[:, :, None]).abs().amax((2, 3)) * 2.4 + 40
        scale = (extent / 200)[..., None].expand(groups, views, 2)
        s_mult = 1 + mix["scale_factor"] * uniform(g, (groups, views), -1, 1,
                                                   device)
        rot = mix["rot_factor"] * uniform(g, (groups, views), -1, 1, device)
        flip = (torch.rand((groups, views), generator=g, device=device)
                < 0.5).float()
        m = geometry.affine(center, scale * s_mult[..., None], rot, (w, h))
        m_flip = m.clone()
        m_flip[..., 0, :] = -m[..., 0, :]
        m_flip[..., 0, 2] += w - 1.0
        out.append({
            "input": crops(g, (groups, views, h, w, 3), device),
            "center": center, "scale": scale.contiguous(), "camera": cams,
            "joints_vis": torch.ones((groups, views, j), device=device),
            "input_aug": crops(g, (groups, views, h, w, 3), device),
            "aug_M": torch.where(flip[..., None, None] > 0.5, m_flip, m),
            "aug_flip": flip})
    return out
