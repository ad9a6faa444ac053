"""Milliseconds a step of the unfused train step on the card, for A/B
runs of two checkouts on one card.

    python -m epipolarpose_tpu_torch.tools.time_eager_step
    PYTHONPATH=<other checkout> python epipolarpose_tpu_torch/tools/time_eager_step.py

Times ``make_train_step`` (``TPU.FUSED_STEPS`` 1, the config's cuDNN
settings, random weights and one seeded batch on the card) at the
flagship FS config (ResNet-50@256, batch 32) and at ResNet-152@384
(batch 24) without and with ``TPU.REMAT``: 3 warm-up steps, then the
median of 3 windows. Prints one JSON line of ms a step, the card's name
and its power limit. The package is whichever ``epipolarpose_tpu_torch``
the import finds first, so ``PYTHONPATH`` picks the checkout.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time

import torch

CASES = (("r50_b32", "h36m/train_fs_r50_256_integral.yaml", False, 32, 20),
         ("r152_b24", "h36m/train_fs_r152_384_integral.yaml", False, 24, 8),
         ("r152_b24_remat", "h36m/train_fs_r152_384_integral.yaml", True, 24,
          8))


def time_steps(experiments: pathlib.Path) -> dict:
    from epipolarpose_tpu_torch.config import load_config
    from epipolarpose_tpu_torch.core import (create_train_state,
                                             make_train_step)
    from epipolarpose_tpu_torch.core.steps import configure_backends
    from epipolarpose_tpu_torch.models import get_model
    from epipolarpose_tpu_torch.tools.profile_step import seeded_train_batch
    out = {}
    for name, yaml, remat, batch, steps in CASES:
        cfg = load_config(experiments / yaml)
        cfg.TPU.REMAT = remat
        configure_backends(cfg)
        with torch.device("cuda"):
            model = get_model(cfg, True)
        state = create_train_state(cfg, model, 1000, "cuda")
        step = make_train_step(cfg, model, device="cuda")
        size = int(cfg.MODEL.IMAGE_SIZE[0])
        b = seeded_train_batch(batch, size, int(cfg.MODEL.NUM_JOINTS),
                               1000.0, torch.Generator("cuda").manual_seed(1),
                               "cuda")
        for _ in range(3):
            step(state, b)
        torch.cuda.synchronize()
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(steps):
                step(state, b)
            torch.cuda.synchronize()
            windows.append((time.perf_counter() - t0) * 1e3 / steps)
        out[name] = sorted(windows)[1]
        del model, state, step
        torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_eager_step: no CUDA device")
    root = pathlib.Path(__file__).resolve().parents[2]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    import epipolarpose_tpu_torch
    print(json.dumps({"package": str(pathlib.Path(
        epipolarpose_tpu_torch.__file__).parent), "card": smi,
        "ms_a_step": time_steps(root / "experiments")}), flush=True)


if __name__ == "__main__":
    main()
