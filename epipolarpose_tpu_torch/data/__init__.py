"""Datasets and loaders: the MPII, H36M and MPI-INF-3DHP readers, the
synthetic datasets and rig, the feeding pipeline with its worker-process
loader, and the offline pseudo-GT merge.

``get_dataset`` mirrors the reference's ``dataset.<name>(cfg, root,
image_set, is_train)``; normalization happens in the step, on the card.
"""

from epipolarpose_tpu_torch.data.grain_pipeline import (  # noqa: F401
    grain_epoch_loader,
)
from epipolarpose_tpu_torch.data.h36m import H36MDataset  # noqa: F401
from epipolarpose_tpu_torch.data.joints_dataset import (  # noqa: F401
    IMAGENET_MEAN,
    IMAGENET_STD,
    JointsDataset,
    JointsRecord,
)
from epipolarpose_tpu_torch.data.mpi3dhp import MPI3DHPDataset  # noqa: F401
from epipolarpose_tpu_torch.data.mpii import MPIIDataset  # noqa: F401
from epipolarpose_tpu_torch.data.pipeline import (  # noqa: F401
    device_prefetch,
    epoch_loader,
    host_prefetch,
)
from epipolarpose_tpu_torch.data.pseudo_gt import (  # noqa: F401
    merge_pseudo_gt_into_annot,
)
from epipolarpose_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticMultiviewDataset,
    SyntheticPoseDataset,
    make_rig,
    skeleton_template,
    synth_skeleton_poses,
    write_synthetic_h36m,
    write_synthetic_mpii,
)

_REGISTRY = {
    "mpii": MPIIDataset,
    "h36m": H36MDataset,
    "mpi_inf_3dhp": MPI3DHPDataset,
    "synthetic": SyntheticPoseDataset,
    "synthetic_multiview": SyntheticMultiviewDataset,
}


def get_dataset(cfg, image_set: str, is_train: bool, **kwargs):
    """The dataset named by ``cfg.DATASET.DATASET``."""
    name = cfg.DATASET.DATASET
    if name not in _REGISTRY:
        raise ValueError(f"unknown DATASET.DATASET: {name}")
    cls = _REGISTRY[name]
    if name.startswith("synthetic"):
        return cls(cfg, is_train=is_train, **kwargs)
    return cls(cfg, cfg.DATASET.ROOT, image_set, is_train, **kwargs)
