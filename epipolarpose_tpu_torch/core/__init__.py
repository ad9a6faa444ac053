"""Train and eval steps (the self-supervised step among them), training
state, and the epoch loops of the port."""

from epipolarpose_tpu_torch.core.function import (  # noqa: F401
    AverageMeter,
    train,
    validate,
)
from epipolarpose_tpu_torch.core.self_supervised import (  # noqa: F401
    Teacher,
    generate_pseudo_gt,
    load_teacher,
    make_gt_teacher,
    make_ss_train_step,
    teacher_detect,
)
from epipolarpose_tpu_torch.core.steps import (  # noqa: F401
    make_eval_step,
    make_train_step,
    normalize_images,
)
from epipolarpose_tpu_torch.core.train_state import (  # noqa: F401
    TrainState,
    create_train_state,
    make_lr_schedule,
    make_optimizer,
)
