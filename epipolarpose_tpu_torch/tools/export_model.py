"""Serialize the pose model for serving: a ``torch.export`` program.

    python -m epipolarpose_tpu_torch.tools.export_model --cfg experiments/h36m/valid_r50_256_integral.yaml \\
        [--model-file <ckpt>] [--batch-size 8 | --batch-size -1] [--device cuda] --out model.pt2

Counterpart of the JAX package's ``tools/export_model.py``. The artifact
holds the weights and the whole inference computation (normalize ->
``PoseResNet`` forward at the config's compute dtype -> decode), written
with ``torch.export.save``. ``--batch-size -1`` exports a symbolic batch
(``Dim("b")``), so one artifact serves any batch size.

The integral decode is the registered op
``torch.ops.epipolarpose.softmax_integral`` (``kernels/softargmax.py``):
an artifact exported on the card launches the hand-written
``epk_softargmax_fwd`` kernel for each call. The weights, and the device
of the forward's ``torch.autocast``, are fixed when the program is
exported, so an artifact serves the device it was exported on; the
device and the config are kept in the artifact's extra files.

:func:`load_exported` serves an artifact in a process that imports only
``torch`` and the op's module: no model code, no config code.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

# names of the artifact's extra files
EXTRA_DEVICE = "device"
EXTRA_CONFIG = "config.json"


class Predict(torch.nn.Module):
    """The inference computation over a model's weights.

    Input: images (N, H, W, 3) float32 in [0, 1], as the JAX package's
    artifact takes them. Output: ``integral`` -> (N, J, 3) float32
    normalized (x, y, z) in [-0.5, 0.5), from the registered soft-argmax
    op; ``gaussian`` -> the float32 heatmaps in the port's NCHW layout,
    (N, J, h, w) (the JAX artifact's are NHWC, (N, h, w, J)). No flip test,
    as in the JAX package.
    """

    def __init__(self, model: torch.nn.Module, normalize, target_type: str,
                 num_joints: int, depth_dim: int):
        super().__init__()
        self.model = model
        self.normalize = normalize
        self.target_type = target_type
        self.num_joints = num_joints
        self.depth_dim = depth_dim

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.normalize(images).permute(0, 3, 1, 2).contiguous()
        out = self.model(x)
        if self.target_type == "gaussian":
            return out.float()
        return torch.ops.epipolarpose.softmax_integral(
            out, self.num_joints, self.depth_dim)


def build_predict_fn(cfg, model: torch.nn.Module) -> Predict:
    """The inference computation of ``cfg`` over ``model``'s weights
    (:class:`Predict`). The model is put in eval mode (BatchNorm on its
    running statistics) and its parameters stop requiring a gradient: the
    module is for inference."""
    from epipolarpose_tpu_torch.core.steps import normalize_images
    from epipolarpose_tpu_torch.kernels import softargmax  # noqa: F401

    target_type = str(cfg.MODEL.EXTRA.TARGET_TYPE)
    if target_type not in ("integral", "gaussian"):
        raise ValueError(f"unknown TARGET_TYPE: {target_type}")
    model.eval().requires_grad_(False)
    return Predict(model, normalize_images, target_type,
                   int(cfg.MODEL.NUM_JOINTS),
                   int(cfg.MODEL.EXTRA.get("DEPTH_DIM", 1))).eval()


def export_model(cfg, model: torch.nn.Module, batch_size: int = 8,
                 device: str | torch.device = "cuda"):
    """``torch.export.export`` of :func:`build_predict_fn` on ``device``
    (the model is moved there). ``batch_size < 0``: a symbolic batch."""
    device = torch.device(device)
    predict = build_predict_fn(cfg, model).to(device)
    w, h = (int(v) for v in cfg.MODEL.IMAGE_SIZE)
    n = 2 if batch_size < 0 else int(batch_size)
    example = torch.rand((n, h, w, 3),
                         generator=torch.Generator().manual_seed(0))
    dynamic = ({0: torch.export.Dim("b")},) if batch_size < 0 else None
    return torch.export.export(predict, (example.to(device),),
                               dynamic_shapes=dynamic)


def _spec(node) -> str:
    val = node.meta.get("val")
    if val is None:
        return node.name
    shape = ", ".join(str(d) for d in val.shape)
    return f"{str(val.dtype).replace('torch.', '')}[{shape}]"


def specs(program) -> tuple[list[str], list[str]]:
    """(input specs, output specs) of an exported program as
    ``dtype[dims]`` strings; a symbolic dimension shows its symbol."""
    user = set(program.graph_signature.user_inputs)
    ins = [_spec(n) for n in program.graph.nodes
           if n.op == "placeholder" and n.name in user]
    out = next(n for n in program.graph.nodes if n.op == "output")
    return ins, [_spec(n) for n in out.args[0]]


def save_exported(program, path: str, device: str | torch.device,
                  cfg) -> float:
    """Write ``program`` with its device and config as extra files;
    returns the file's size in MB."""
    torch.export.save(program, path, extra_files={
        EXTRA_DEVICE: torch.device(device).type,
        EXTRA_CONFIG: json.dumps(cfg, sort_keys=True)})
    return os.path.getsize(path) / 1e6


class Exported:
    """A loaded artifact: call it with (N, H, W, 3) float32 images on
    :attr:`device`. Each call runs under ``inference_mode``. ``config``
    is the exporting config (a dict), ``program`` the
    ``ExportedProgram``."""

    def __init__(self, program, device: torch.device, config: dict):
        self.program = program
        self.module = program.module()
        self.device = device
        self.config = config

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        if images.device.type != self.device.type:
            raise ValueError(
                f"the artifact was exported on {self.device.type} and "
                f"serves it; the images are on {images.device}")
        with torch.inference_mode():
            return self.module(images)


def load_exported(path: str) -> Exported:
    """Load an artifact that :func:`main` wrote. Imports only ``torch``
    and the soft-argmax op's module (``kernels/softargmax.py``, which
    registers ``epipolarpose::softmax_integral``)."""
    from epipolarpose_tpu_torch.kernels import softargmax  # noqa: F401

    extra = {EXTRA_DEVICE: "", EXTRA_CONFIG: ""}
    program = torch.export.load(path, extra_files=extra)
    if not extra[EXTRA_DEVICE]:
        raise ValueError(f"{path}: no {EXTRA_DEVICE!r} extra file; not "
                         "written by export_model")
    return Exported(program, torch.device(extra[EXTRA_DEVICE]),
                    json.loads(extra[EXTRA_CONFIG] or "{}"))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--model-file", default=None,
                   help="any checkpoint core/checkpoint.py reads (default: "
                        "TEST.MODEL_FILE; none: the seeded random init)")
    p.add_argument("--batch-size", type=int, default=8,
                   help="-1 exports a symbolic (any) batch dimension")
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Export, save and report; returns the path, the size in MB, the
    specs and the program."""
    args = parse_args(argv)
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.checkpoint import load_model_variables
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.scripts.common import resolve_device

    cfg = load_config(args.cfg)
    device = resolve_device(args.device)
    configure_backends(cfg)
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    model_file = args.model_file or cfg.TEST.MODEL_FILE
    if model_file:
        load_model_variables(model, model_file)
    program = export_model(cfg, model, args.batch_size, device)
    mb = save_exported(program, args.out, device, cfg)
    ins, outs = specs(program)
    print(f"wrote {args.out}: {mb:.1f} MB, in {ins}, out {outs}, "
          f"device {device.type}")
    return dict(path=args.out, mb=mb, inputs=ins, outputs=outs,
                program=program)


if __name__ == "__main__":
    main()
