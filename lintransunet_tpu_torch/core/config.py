"""Typed configs mirroring the reference's argparse surfaces (the port's own
copy of ``lintransunet_tpu/core/config.py``).

Field names and defaults reproduce the public flag surface of
``train3D.py:28-102``, ``train3D_multi_class.py``, ``inference_embed_attn.py:
19-73`` and ``inference_multi_classes.py``: those flags are the reference's
public API. The CLIs build their argparse parsers from these dataclasses, so
the flags stay in one place. The flags differ from the JAX package's in
``device`` alone: ``TrainConfig.device`` defaults to ``"cuda"``, the card
(JAX: ``"tpu"``), and ``InferenceConfig`` gains it (JAX's has none). A
CUDA device with no card visible raises when the model is built.

Three things of the JAX module have no counterpart here, because nothing in
the port would read them: ``ModelConfig.packed_levels`` (the port has no
packed small-C layout), ``EvalConfig.sw_batch_scale`` (no caller reads it
in either package) and ``config_from_args`` (the CLIs read their namespace
directly). No CLI flag comes from them, so the flag surfaces stay equal.
"""

import dataclasses
from typing import Tuple

MODEL_NAMES = ("TraditionUnet", "BottleTransUnet", "SkipTransUnet",
               "MaskSkipTransUnet", "MaskTransUnet")


@dataclasses.dataclass
class ModelConfig:
    """Model construction flags (train3D.py:42-72)."""

    model_name: str = "MaskTransUnet"
    num_layers: Tuple[int, ...] = (16, 32, 64, 128, 256)
    roi_size_list: Tuple[int, ...] = (100, 65, 40, 25, 10)
    is_roi_list: Tuple[bool, ...] = (False, True, True, True, True)
    dim_input: int = 1
    dim_output: int = 2
    kernel_size: int = 3
    dropout: float = 0.3
    # compute dtype ("bfloat16" is the AMP analogue); parameters stay f32
    compute_dtype: str = "bfloat16"
    # transformer depth of every bridge (Unet_3Dblock.py n_layers=8)
    attn_layers: int = 8

    def build(self, device="cuda"):
        """The registry's model of ``model_name`` (``models.Model_Dict``) on
        ``device`` (the card unless the caller asks for the CPU) in the
        compute dtype, its parameters drawn by flax's initialisers from
        torch's global generator (``init_random_`` redraws them from a
        seed). The ROI and depth flags reach ``MaskTransUnet`` alone, as in
        JAX; an unknown name raises ``ValueError``."""
        import torch

        from lintransunet_tpu_torch.models import get_model_dict

        cls = get_model_dict(self.model_name)
        dtypes = {"bfloat16": torch.bfloat16, "float32": torch.float32}
        if self.compute_dtype not in dtypes:
            raise ValueError(f"compute_dtype must be one of {tuple(dtypes)}, "
                             f"not {self.compute_dtype!r}")
        kwargs = dict(num_layers=tuple(self.num_layers), dim_input=self.dim_input,
                      dim_output=self.dim_output, kernel_size=self.kernel_size,
                      dropout=self.dropout, dtype=dtypes[self.compute_dtype],
                      device=device)
        if self.model_name == "MaskTransUnet":
            kwargs.update(roi_size_list=tuple(self.roi_size_list),
                          is_roi_list=tuple(self.is_roi_list), n_layers=self.attn_layers)
        return cls(**kwargs)


@dataclasses.dataclass
class TrainConfig:
    """Training flags (train3D.py:28-102; multi-class deltas noted inline)."""

    dir_data: str = "../../data/CT_Pancreas/Sloan_data"
    is_transform: bool = True
    split_ratio: float = 0.9
    is_pretrained: bool = False
    pretrained_dir: str = ""
    batch_size: int = 3          # patient batch size
    depth_size: int = 32
    num_samples: int = 6
    device: str = "cuda"
    epochs: int = 800
    eval_epoch: int = 5
    log_dir: str = "./runs/log"
    model_dir: str = "./out/log"
    criterion_list: Tuple[str, ...] = ("CrossEntroLoss", "DiceClassLoss")
    criterion_weight: Tuple[float, ...] = (1.0, 1.0)
    weight_list: Tuple[float, ...] = (0.05, 0.05, 0.1, 0.1, 1.0)
    final_weight: Tuple[float, ...] = (2.0, 1.5, 1.0, 1.0, 1.0)
    initial_weight: Tuple[float, ...] = (0.1, 0.2, 0.3, 0.4, 1.0)
    fold_num: int = 0
    split_json: str = "split_dataset_8.json"
    # Optimiser (train3D.py:193-201)
    learning_rate: float = 1e-4
    plateau_factor: float = 0.8
    plateau_patience: int = 5
    plateau_threshold: float = 1e-2
    plateau_cooldown: int = 1
    min_lr: float = 1e-7
    warmup_step: int = 10
    weight_T: float = 12.0
    num_classes: int = 2         # 3 for the multi-class CLI (train3D_multi_class.py:70)
    seed: int = 0


@dataclasses.dataclass
class EvalConfig:
    """Eval-time sliding-window settings (utils_3D_embed_full.py:135-148)."""

    roi_size: int = 512
    depth_size: int = 64
    overlap: float = 0.6
    mode: str = "constant"       # sigma_scale=0 + default constant blending
    threshold: float = 0.5


@dataclasses.dataclass
class InferenceConfig:
    """Inference CLI flags (inference_embed_attn.py:19-73)."""

    dir_data: str = "/data/datasets/zheyuan/Raw_Pancreas"
    pretrained_dir: str = ""
    batch_size: int = 1
    depth_size: int = 32
    roi_size: int = 512
    sw_batch_size: int = 4
    overlap: float = 0.6
    threshold: float = 0.5
    criterion_list: Tuple[str, ...] = (
        "DiceClassLoss", "Recall", "Precision", "LocalizationLoss")
    is_save: bool = False
    saved_folder: str = "./prediction/test"
    fold_nums: int = 1
    split_json: str = "split_dataset_8.json"
    device: str = "cuda"         # the port's own flag (the JAX CLI has none)


def add_dataclass_args(parser, config) -> None:
    """Register every dataclass field as an argparse flag (lists comma-split)."""
    for field in dataclasses.fields(config):
        default = getattr(config, field.name)
        if isinstance(default, bool):
            parser.add_argument(f"--{field.name}", type=lambda s: s.lower() in
                                ("1", "true", "yes"), default=default)
        elif isinstance(default, tuple):
            elem = type(default[0]) if default else str
            parser.add_argument(
                f"--{field.name}",
                type=lambda s, e=elem: tuple(e(x) for x in s.split(",")),
                default=default)
        else:
            parser.add_argument(f"--{field.name}", type=type(default),
                                default=default)

