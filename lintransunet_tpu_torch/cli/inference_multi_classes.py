"""Multi-class full-volume inference CLI (port of
``lintransunet_tpu/cli/inference_multi_classes.py``; mirrors
inference_multi_classes.py:1-163).

The binary CLI (``inference_embed_attn``) with the reference's multi-class
deltas: the full-channel blend rounded, then
KeepLargestConnectedComponent(applied_labels=(1, 2), independent=False,
connectivity=3) (:104, 148-151), the background rebuilt as
p0 = 1 - p1 - p2 (:152), one-hot labels (:131-137), the 7-entry criterion
suite with Recall2 and Precision2 (:57-59), and the argmax exported as a
(D, H, W) uint8 volume (:157-163). The same flags as the JAX CLI, and
``--device`` (the card, ``cuda``, by default; ``--device cpu`` runs on the
CPU). Run:

    python -m lintransunet_tpu_torch.cli.inference_multi_classes \\
        --dir_data <root> --pretrained_dir <run> --split_json <split>
"""

from lintransunet_tpu_torch.cli import inference_embed_attn
from lintransunet_tpu_torch.core.config import InferenceConfig

CRITERIA = ("DiceClassLoss0", "DiceClassLoss", "DiceClassLoss2",
            "Recall", "Precision", "Recall2", "Precision2")


def get_parse():
    parser = inference_embed_attn.model_parser(InferenceConfig(criterion_list=CRITERIA),
                                               dim_output=3)
    parser.add_argument("--num_classes", type=int, default=3)
    parser.add_argument("--attn_layers", type=int, default=8)
    return parser.parse_args()


def main(args):
    inference_embed_attn.main(args, multi_class=True)


if __name__ == "__main__":
    main(get_parse())
