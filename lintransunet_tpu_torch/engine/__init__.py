"""Runtime engine: the training step, its schedules and checkpoints, the
eval forward and sliding-window inference."""

from lintransunet_tpu_torch.engine.checkpoint import restore_train_state, save_train_state
from lintransunet_tpu_torch.engine.schedule import (
    ReduceLROnPlateau,
    get_dynamic_weight,
    get_weight,
)
from lintransunet_tpu_torch.engine.sliding_window import (
    SlidingWindowRunner,
    sliding_window_inference,
)
from lintransunet_tpu_torch.engine.train import (
    TrainState,
    apply_gradients,
    create_train_state,
    deep_supervision_loss,
    get_learning_rate,
    label_pyramid_kernel,
    make_eval_forward,
    make_optimizer,
    make_train_step,
    set_learning_rate,
)

__all__ = [
    "SlidingWindowRunner",
    "sliding_window_inference",
    "make_eval_forward",
    "TrainState",
    "apply_gradients",
    "create_train_state",
    "deep_supervision_loss",
    "get_learning_rate",
    "label_pyramid_kernel",
    "make_optimizer",
    "make_train_step",
    "set_learning_rate",
    "get_dynamic_weight",
    "get_weight",
    "ReduceLROnPlateau",
    "save_train_state",
    "restore_train_state",
]
