"""Core: typed configs."""

from lintransunet_tpu_torch.core.config import (
    EvalConfig,
    InferenceConfig,
    ModelConfig,
    TrainConfig,
    add_dataclass_args,
)

__all__ = ["ModelConfig", "TrainConfig", "EvalConfig", "InferenceConfig",
           "add_dataclass_args"]
