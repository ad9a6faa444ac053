"""Export a checkpoint as a reference-format ``.pth.tar``.

    python -m epipolarpose_tpu_torch.tools.export_torch --cfg experiments/h36m/valid_r50_256_integral.yaml \\
        --model-file output/.../checkpoints/latest --out model.pth.tar

Counterpart of the JAX package's ``tools/export_torch.py``. Reads any
file the port writes (a latest or best training checkpoint with its
optimizer, ``final_state``) or a reference ``.pth(.tar)``, loads it into
the config's ``PoseResNet`` with ``strict=True`` (names and shapes), and
writes ``{"state_dict": ...}`` under the reference names, which the
reference's PyTorch ``PoseResNet`` and the JAX package's
``load_torch_checkpoint`` read. Entries are the model's own: float32
weights and BN statistics, and each BN's ``num_batches_tracked``. An
orbax directory raises with the hint to export it with the JAX package
first (``core/checkpoint.py::ORBAX_HINT``).
"""

from __future__ import annotations

import argparse

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cfg", required=True)
    p.add_argument("--model-file", required=True,
                   help="a port checkpoint (file, checkpoints root, best/, "
                        "latest) or a reference .pth(.tar)")
    p.add_argument("--out", required=True, help="output .pth.tar path")
    return p.parse_args(argv)


def main(argv=None) -> dict[str, torch.Tensor]:
    """Write the checkpoint; returns the state_dict written."""
    args = parse_args(argv)
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core.checkpoint import (atomic_save,
                                                        load_model_variables)
    from epipolarpose_tpu_torch.models import get_model

    cfg = load_config(args.cfg)
    model = get_model(cfg, False, torch.Generator().manual_seed(0))
    load_model_variables(model, args.model_file, strict=True)
    state_dict = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    atomic_save({"state_dict": state_dict}, args.out)
    print(f"wrote {args.out}")
    return state_dict


if __name__ == "__main__":
    main()
