"""One rank of the two-process fused runs of
``tests/test_torch_fused_steps.py``.

    python tests/torch_fused_worker.py <directory>

with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` set: joins the ``gloo``
group through ``file://<directory>/rendezvous``, reads
``<directory>/inputs.pt`` (weights and K global batches), takes this
rank's slice of each batch, stacks them into one super-batch and runs the
fused FS step (``fused_steps=K``) through ``parallel.wrap_model``; writes
``<directory>/rank<r>.pt``. Imports the port only.
"""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from epipolarpose_tpu_torch.config import load_config  # noqa: E402
from epipolarpose_tpu_torch.core import (create_train_state,  # noqa: E402
                                         make_train_step)
from epipolarpose_tpu_torch.data import stack_batches  # noqa: E402
from epipolarpose_tpu_torch.models import get_pose_net  # noqa: E402
from epipolarpose_tpu_torch.parallel import (init_distributed,  # noqa: E402
                                             process_count, process_index,
                                             wrap_model)
from torch_parallel_worker import shard  # noqa: E402

DEBUG_3D = ROOT / "experiments/debug/synth_smoke_3d.yaml"
WORLD = 2
K = 2


def main(directory: str) -> None:
    directory = pathlib.Path(directory)
    init_distributed("cpu", init_method=f"file://{directory}/rendezvous")
    rank, world = process_index(), process_count()
    inp = torch.load(directory / "inputs.pt", weights_only=False)
    cfg = load_config(DEBUG_3D)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    model = get_pose_net(cfg)
    model.load_state_dict(inp["state_dict"], strict=True)
    state = create_train_state(cfg, model, steps_per_epoch=10, device="cpu")
    step = make_train_step(cfg, wrap_model(model), "cpu", fused_steps=K)
    mine = [shard(b, rank, world) for b in inp["batches"]]
    state, metrics = step(state, next(stack_batches(iter(mine), K)))
    torch.save({"loss": metrics["loss"].numpy(), "step": state.step,
                "state_dict": {k: v.clone() for k, v in
                               model.state_dict().items()}},
               directory / f"rank{rank}.pt")
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    torch.set_num_threads(1)
    main(sys.argv[1])
