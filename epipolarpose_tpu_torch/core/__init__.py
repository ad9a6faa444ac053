"""Train and eval steps (the self-supervised step among them), training
state, the epoch loops, checkpoints, the run's logger, and the refinement
unit's training."""

from epipolarpose_tpu_torch.core.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_model_variables,
    merge_matching,
    read_state_dict,
    resolve_checkpoint_path,
)

from epipolarpose_tpu_torch.core.function import (  # noqa: F401
    AverageMeter,
    train,
    validate,
)
from epipolarpose_tpu_torch.core.logger import (  # noqa: F401
    create_logger,
    create_metric_writer,
)
from epipolarpose_tpu_torch.core.refine import (  # noqa: F401
    create_refiner_state,
    make_refiner_apply,
    make_refiner_train_step,
    synth_noise,
)
from epipolarpose_tpu_torch.core.self_supervised import (  # noqa: F401
    Teacher,
    generate_pseudo_gt,
    load_refiner,
    load_teacher,
    make_gt_teacher,
    make_ss_train_step,
    teacher_detect,
)
from epipolarpose_tpu_torch.core.steps import (  # noqa: F401
    FusedSteps,
    fuse_steps,
    make_eval_step,
    make_train_step,
    normalize_images,
)
from epipolarpose_tpu_torch.core.train_state import (  # noqa: F401
    MultiStepSchedule,
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
