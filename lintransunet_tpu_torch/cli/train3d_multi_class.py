"""Multi-class CT training CLI (port of
``lintransunet_tpu/cli/train3d_multi_class.py``; mirrors
train3D_multi_class.py:1-298).

The binary CLI (``train3d``) with the reference's multi-class deltas: 3
output classes, the criterion weights (10, 1, 2) on one-hot targets, CE +
Dice1 + Dice2 at every level, plateau factor 0.6 and patience 4, and model
selection on DiceClassLoss + DiceClassLoss2 (utils_3D_multi_class.py:
201-204). The same flags and defaults as the JAX CLI, and ``--device`` (the
card, ``cuda``, by default; ``--device cpu`` runs on the CPU). Run:

    python -m lintransunet_tpu_torch.cli.train3d_multi_class --dir_data <root>
"""

from lintransunet_tpu_torch.cli import train3d
from lintransunet_tpu_torch.core.config import TrainConfig

MULTI_CLASS = dict(
    criterion_list=("CrossEntroLoss", "DiceClassLoss", "DiceClassLoss2"),
    criterion_weight=(10.0, 1.0, 2.0),
    plateau_factor=0.6,
    plateau_patience=4,
    num_classes=3,
)


def get_parse():
    return train3d.model_parser(TrainConfig(**MULTI_CLASS), dim_output=3).parse_args()


def main(args):
    train3d.main(args, multi_class=True)


if __name__ == "__main__":
    main(get_parse())
