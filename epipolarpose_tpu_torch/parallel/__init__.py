"""Data parallelism over processes: one process per card under
``torch.distributed.run``, the global batch split across them, batch
norm over the global batch and DDP's mean of the gradients. The
counterpart of the JAX package's ``parallel`` (a device mesh with a
``data`` axis); its ``model`` axis is not ported."""

from epipolarpose_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum,
    init_distributed,
    make_mesh,
    mean_over_processes,
    pod_sync,
    process_allgather,
    process_count,
    process_index,
    refuse_model_axis,
    unwrap,
    wrap_model,
)
