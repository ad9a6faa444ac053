"""The reference's three jobs, in plain PyTorch float32 (float64 for the
triangulation), on the benchmark's weights and batches:

- :func:`train_steps`: fully supervised 3D training steps (forward in
  train mode, soft-argmax, integral L1 loss, backward, Adam);
- :func:`ss_steps`: self-supervised steps (the frozen 2D teacher in eval
  mode, its argmax decode with the quarter-pixel offset, undistortion,
  confidence-weighted DLT, reprojection, dual-crop targets, then the
  student's train step);
- :func:`eval_preds`: the flip test (the mirrored forward flipped back,
  its left and right joints swapped, shifted one pixel right and
  averaged in), the soft-argmax, and the predictions in source pixels and
  millimetres.

``quant`` (see :mod:`benchmark.reference.quant`) computes the network in
a lower precision; ``tri_round`` the triangulation (float32 with every
operand rounded); ``half`` trains on the first half of each batch,
``shift_mm`` moves the pseudo-GT, ``fault`` breaks the flip test (planted
faults). With them the reference stands in the program's place
as the control of the correctness check.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import geometry, integral
from benchmark.reference import model as ref_model

# rows a block of the training head: the final convolution and the
# soft-argmax run in blocks, each computed again in the backward pass, as
# a float32 volume of a whole batch and its softmax (7.7 GB each at
# ResNet-152@384's 192 crops) would not fit beside the rest
HEAD_ROWS = 32


def leaf_norms(tensors) -> torch.Tensor:
    return torch.stack([t.detach().float().norm() for t in tensors])


def _student(params: dict, arch: dict):
    names = ref_model.trainable(arch)
    leaves = [params[n].detach().clone().requires_grad_() for n in names]
    p = dict(params)
    p.update(zip(names, leaves))
    return p, leaves


def _train_step(p, leaves, opt, crops, tgt, tw, arch, quant, half):
    if half:
        keep = crops.shape[0] // 2
        crops, tgt, tw = crops[:keep], tgt[:keep], tw[:keep]
    x = integral.normalize(crops).to(leaves[0].dtype)
    feats = ref_model.forward(p, x, arch, True, quant=quant, head=False)

    def head(f):
        return integral.soft_argmax(ref_model.final(p, f, arch, quant),
                                    arch["num_joints"], arch["depth_dim"])
    coords = torch.cat([checkpoint(head, f, use_reentrant=False)
                        for f in feats.split(HEAD_ROWS)])
    loss = integral.l1_loss(coords, tgt, tw)
    grads = torch.autograd.grad(loss, leaves)
    del feats, coords
    opt.step(grads)
    return loss.detach(), grads


def train_steps(params: dict, arch: dict, batches: list, lr: float,
                quant=None, half: bool = False) -> dict:
    """Steps of Adam at rate ``lr`` from ``params``, one a batch. Returns
    ``loss`` (steps,), ``grad1`` the first step's gradient norm by leaf,
    ``change`` the norm of each leaf's change after the last step."""
    p, leaves = _student(params, arch)
    start = [t.detach().clone() for t in leaves]
    opt = integral.Adam(leaves, lr)
    losses, grad1 = [], None
    for b in batches:
        z = b["joints_3d"][..., 2]
        tgt, tw = integral.targets(b["joints"], b["joints_vis"],
                                   arch["image_size"], arch["depth_bound"],
                                   z - z[:, :1])
        loss, grads = _train_step(p, leaves, opt, b["input"], tgt, tw, arch,
                                  quant, half)
        losses.append(loss)
        if grad1 is None:
            grad1 = leaf_norms(grads)
    return {"loss": torch.stack(losses), "grad1": grad1,
            "change": leaf_norms([a - b for a, b in zip(leaves, start)])}


def decode_maps(hm: torch.Tensor, center: torch.Tensor, scale: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Heatmaps (B, J, h, w) -> source pixels (B, J, 2) and confidences
    (B, J): the first maximum (coordinates 0 where it is not positive),
    then a quarter pixel toward the larger neighbour on each axis where
    the maximum lies off the border, back through the box's affine."""
    b, j, h, w = hm.shape
    flat = hm.reshape(b, j, h * w).float()
    idx = flat.argmax(-1)
    conf = flat.amax(-1)
    pos = torch.stack([idx % w, idx // w], -1) * (conf > 0)[..., None]
    px, py = pos[..., 0], pos[..., 1]

    def at(x, y):
        lin = y.clamp(0, h - 1) * w + x.clamp(0, w - 1)
        return torch.gather(flat, -1, lin[..., None])[..., 0]

    off = torch.stack([torch.sign(at(px + 1, py) - at(px - 1, py)),
                       torch.sign(at(px, py + 1) - at(px, py - 1))], -1)
    inner = (px > 1) & (px < w - 1) & (py > 1) & (py < h - 1)
    xy = pos.float() + 0.25 * off * inner[..., None]
    m = geometry.affine(center.double(), scale.double(),
                        torch.zeros_like(center[..., 0]).double(), (w, h),
                        inv=True)
    return geometry.apply_affine(xy.double(), m), conf


def teacher_maps(tparams: dict, tarch: dict, crops: torch.Tensor,
                 quant=None) -> torch.Tensor:
    with torch.no_grad():
        return ref_model.forward(tparams, integral.normalize(crops), tarch,
                                 False, quant=quant)


def ss_steps(params: dict, tparams: dict, arch: dict, tarch: dict,
             batches: list, lr: float, ss: dict, quant=None,
             tri_round=None, follow: dict | None = None,
             half: bool = False, shift_mm: float = 0.0) -> dict:
    """Self-supervised steps. ``ss``: ``conf_min``, ``flip_pairs``.
    Returns ``hm`` (the reference's teacher maps, one (G*V, J, h, w) a
    step), ``X`` (its pseudo-GT, one (G, J, 3) a step) and
    :func:`train_steps`' readings.

    ``follow``: the program's ``hm`` and ``X`` of the same steps. The
    reference then decodes the program's maps and triangulates those
    detections, judges the program's points against that system
    (``excess``, one (G, J) a step, :func:`geometry.dlt_excess`), and
    trains the student on the program's points: with random weights the
    teacher's argmax and the rays' meeting point are not well posed, so
    the reference follows the program through them and checks each
    stage by itself. ``shift_mm`` moves every pseudo-GT point by that
    much on each axis where it is produced (a planted fault)."""
    j = arch["num_joints"]
    perm = list(range(j))
    for a, b in ss["flip_pairs"]:
        perm[a], perm[b] = perm[b], perm[a]
    p, leaves = _student(params, arch)
    start = [t.detach().clone() for t in leaves]
    opt = integral.Adam(leaves, lr)
    out = {"hm": [], "X": [], "excess": [], "loss": [], "grad1": None}
    for k, b in enumerate(batches):
        g, v = b["input"].shape[:2]
        cam = {n: t.double() for n, t in b["camera"].items()}
        center = b["center"].reshape(g * v, 2)
        scale = b["scale"].reshape(g * v, 2)
        own = teacher_maps(tparams, tarch, b["input"].flatten(0, 1), quant)
        out["hm"].append(own)
        hm = own if follow is None else follow["hm"][k]
        det, conf = decode_maps(hm, center, scale)
        det = det.reshape(g, v, j, 2)
        conf = conf.reshape(g, v, j)
        with torch.no_grad():
            und = geometry.undistort(det, cam)
            P = geometry.projection_matrix(cam)
            x = geometry.triangulate(geometry.dlt_normal(und, P, conf,
                                                         tri_round))
            x = x + shift_mm
            out["X"].append(x.float())
            if follow is not None:
                x = follow["X"][k].double()
                out["excess"].append(geometry.dlt_excess(
                    geometry.dlt_normal(und, P, conf), x))
            x_cam = geometry.world_to_camera(x[:, None], cam["R"], cam["T"])
            px = geometry.project(x[:, None], cam).reshape(g * v, j, 2)
            z = x_cam[..., 2].reshape(g * v, j)
            z = z - z[:, :1]
            ok = (conf.amin(1) > ss["conf_min"]).float()
            vis = b["joints_vis"].reshape(g * v, j) \
                * ok.repeat_interleave(v, 0)
            xy = geometry.apply_affine(px, b["aug_M"].reshape(g * v, 2, 3)
                                       .double())
            flip = b["aug_flip"].reshape(g * v)[:, None] > 0.5
            xy = torch.where(flip[..., None], xy[:, perm], xy)
            z = torch.where(flip, z[:, perm], z)
            vis = torch.where(flip, vis[:, perm], vis)
            tgt, tw = integral.targets(xy.float(), vis, arch["image_size"],
                                       arch["depth_bound"], z.float())
            tw = tw * torch.isfinite(tgt).all(-1).float()
            tgt = torch.nan_to_num(tgt)
        loss, grads = _train_step(p, leaves, opt,
                                  b["input_aug"].flatten(0, 1), tgt, tw,
                                  arch, quant, half)
        out["loss"].append(loss)
        if out["grad1"] is None:
            out["grad1"] = leaf_norms(grads)
    out["loss"] = torch.stack(out["loss"])
    out["change"] = leaf_norms([a - b for a, b in zip(leaves, start)])
    return out


def flip_back(vol: torch.Tensor, joints: int, depth: int,
              pairs, fault: str | None = None) -> torch.Tensor:
    """A mirrored image's (N, J*D, H, W) output -> the original's frame:
    flipped along W, left and right joints swapped, shifted one pixel
    right (the first column kept). ``fault`` leaves out the shift
    (``no_shift``) or the swap (``no_swap``)."""
    n, _, h, w = vol.shape
    v = vol.reshape(n, joints, depth, h, w).flip(-1)
    perm = list(range(joints))
    for a, b in pairs:
        perm[a], perm[b] = perm[b], perm[a]
    if fault != "no_swap":
        v = v[:, perm]
    v = v.reshape(n, joints * depth, h, w)
    if fault == "no_shift":
        return v
    return torch.cat([v[..., :1], v[..., :-1]], -1)


@torch.no_grad()
def eval_preds(params: dict, arch: dict, batch: dict, pairs,
               quant=None, fault: str | None = None) -> torch.Tensor:
    """(N, J, 3): x, y in source pixels, z in mm from the root's plane;
    ``fault`` as :func:`flip_back` takes it."""
    j, d = arch["num_joints"], arch["depth_dim"]
    x = integral.normalize(batch["input"]).to(params["conv1.weight"].dtype)
    out = ref_model.forward(params, x, arch, False, quant=quant)
    out_f = ref_model.forward(params, x.flip(-1), arch, False, quant=quant)
    vol = (out + flip_back(out_f, j, d, pairs, fault)) * 0.5
    del out, out_f
    coords = integral.soft_argmax(vol, j, d)
    size = torch.tensor(arch["image_size"], dtype=x.dtype, device=x.device)
    xy_crop = (coords[..., :2] + 0.5) * size
    m = geometry.affine(batch["center"], batch["scale"],
                        torch.zeros_like(batch["center"][..., 0]),
                        arch["image_size"], inv=True)
    xy = geometry.apply_affine(xy_crop, m)
    z = coords[..., 2] * 2.0 * arch["depth_bound"]
    return torch.cat([xy, z[..., None]], -1)
