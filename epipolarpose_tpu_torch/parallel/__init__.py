"""Data parallelism and the model axis over processes: one process per
card under ``torch.distributed.run``, a ``(data, model)`` mesh of them.
The global batch is split over ``data``; each batch's image rows over
``model``, with halo exchanges in every row-sensitive layer; batch norm
runs over the global batch and DDP takes the mean of the gradients. The
counterpart of the JAX package's ``parallel``."""

from epipolarpose_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum,
    check_row_split,
    data_count,
    data_group,
    data_index,
    group_allgather,
    init_distributed,
    make_mesh,
    mean_over_processes,
    model_count,
    model_group,
    model_index,
    pod_sync,
    process_allgather,
    process_count,
    process_index,
    unwrap,
    wrap_model,
)
from epipolarpose_tpu_torch.parallel.spatial import (  # noqa: F401
    gather_rows,
    halo_exchange,
    local_rows,
)
