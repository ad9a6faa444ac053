"""The reference against a float64 evaluation of itself at a tiny size,
and its geometry against cases with known answers."""

from __future__ import annotations

import math

import torch

from benchmark import weights
from benchmark.reference import geometry, integral, steps
from benchmark.reference import model as ref_model
from benchmark.spec import Spec

ARCH = dict(num_layers=50, num_joints=17, depth_dim=4, image_size=[64, 64],
            heatmap_size=[16, 16], deconv_filters=[16, 16, 16],
            deconv_kernels=[4, 4, 4], final_kernel=1, depth_bound=1000.0)
CPU = torch.device("cpu")


def _double(p: dict) -> dict:
    return {k: v.double() if v.is_floating_point() else v
            for k, v in p.items()}


def _pool(kind: str, **mix):
    torch.set_num_threads(2)
    return Spec().generator(kind).pool(
        dict(mix, kind=kind, pool=3), ARCH,
        weights.generator(3, weights.DATA, CPU), CPU)


def test_forward_and_decode_agree_with_float64():
    p = weights.make(ARCH, 7, weights.WEIGHTS, CPU)
    b = _pool("fs", batch=4, depth_mm=900.0, vis_share=1.0)[0]
    x = integral.normalize(b["input"])
    for train in (True, False):
        got = integral.soft_argmax(ref_model.forward(p, x, ARCH, train),
                                   17, 4)
        want = integral.soft_argmax(
            ref_model.forward(_double(p), x.double(), ARCH, train), 17, 4)
        assert (got.double() - want).abs().max() < 1e-5


def test_train_steps_agree_with_float64():
    p = weights.make(ARCH, 7, weights.WEIGHTS, CPU)
    batches = _pool("fs", batch=4, depth_mm=900.0, vis_share=0.9)
    got = steps.train_steps(p, ARCH, batches, 1e-3)
    want = steps.train_steps(_double(p), ARCH,
                             [{k: v.double() if v.is_floating_point()
                               else v for k, v in b.items()}
                              for b in batches], 1e-3)
    loss = ((got["loss"].double() - want["loss"]) / want["loss"]).abs()
    # the first step is a forward pass from equal weights; Adam's first
    # updates, about the rate times the gradient's sign, carry float32's
    # rounding of small gradients into the later steps
    assert loss[0] < 1e-6 and loss.max() < 1e-3
    rel = (got["grad1"].double() - want["grad1"]) / want["grad1"]
    assert rel.abs().median() < 1e-4


def test_eval_predictions_agree_with_float64():
    p = weights.make(ARCH, 7, weights.WEIGHTS, CPU)
    b = _pool("eval", batch=2)[0]
    pairs = [(1, 4), (2, 5)]
    got = steps.eval_preds(p, ARCH, b, pairs)
    want = steps.eval_preds(_double(p), ARCH,
                            {k: v.double() if v.is_floating_point() else v
                             for k, v in b.items()}, pairs)
    assert (got[..., :2].double() - want[..., :2]).abs().max() < 1e-3
    assert (got[..., 2].double() - want[..., 2]).abs().max() < 1e-2


def test_geometry_on_known_answers():
    b = _pool("ss", groups=2, views=4, pose_noise_mm=40.0,
              scale_factor=0.25, rot_factor=30.0)[0]
    cam = {k: v.double() for k, v in b["camera"].items()}
    world = torch.randn(2, 17, 3, dtype=torch.float64) * 300 \
        + torch.tensor([0.0, 0.0, 800.0], dtype=torch.float64)
    px = geometry.project(world[:, None], cam)              # (G, V, J, 2)
    und = geometry.undistort(px, cam, iters=20)
    P = geometry.projection_matrix(cam)
    xh = torch.cat([world, torch.ones_like(world[..., :1])], -1)
    pin = torch.einsum("gvij,gnj->gvni", P, xh)
    pin = pin[..., :2] / pin[..., 2:3]
    assert (und - pin).abs().max() < 1e-3
    ata = geometry.dlt_normal(pin, P, torch.ones(2, 4, 17,
                                                  dtype=torch.float64))
    assert (geometry.triangulate(ata) - world).abs().max() < 1e-4
    assert geometry.dlt_excess(ata, world).abs().max() < 1e-9
    m = geometry.affine(b["center"].double(), b["scale"].double(),
                        torch.full((2, 4), 17.0, dtype=torch.float64),
                        (64, 64))
    back = geometry.affine(b["center"].double(), b["scale"].double(),
                           torch.full((2, 4), 17.0, dtype=torch.float64),
                           (64, 64), inv=True)
    pts = torch.rand(2, 4, 5, 2, dtype=torch.float64) * 64
    there = geometry.apply_affine(geometry.apply_affine(pts, back), m)
    assert (there - pts).abs().max() < 1e-9
    # the box's centre maps to the crop's
    c = geometry.apply_affine(b["center"].double()[..., None, :], m)
    assert (c - 32.0).abs().max() < 1e-9
    assert math.isclose(float(m[0, 0, 0, :2].norm()),
                        64 / (200 * float(b["scale"][0, 0, 0])), rel_tol=1e-9)
