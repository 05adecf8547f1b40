"""Binary full-volume inference CLI (port of
``lintransunet_tpu/cli/inference_embed_attn.py``; mirrors
inference_embed_attn.py:1-190).

Per fold: load the best parameters (``temp_model``, written by
``train3d``), sliding-window inference with ``roi_size`` x ``roi_size`` x
``depth_size`` windows, the given overlap and constant blending, threshold
0.5, the metric suite Dice/Recall/Precision/Localization, an optional
``.npy`` export of the class-1 channel as a (D, H, W) binary volume, and
the per-patient and aggregate summary ``summary_4_fold.json`` in the
working directory. The same flags as the JAX CLI, and ``--device`` (the
card, ``cuda``, by default; ``--device cpu`` runs on the CPU). Run:

    python -m lintransunet_tpu_torch.cli.inference_embed_attn \\
        --dir_data <root> --pretrained_dir <run> --split_json <split>

Under ``torchrun`` the ranks split the volumes, one card each
(``SlidingWindowRunner.run_batch``, as the JAX CLI shards them over its
chips); rank 0 scores every volume and writes the exports and the summary.
"""

import argparse
import json
import os

import numpy as np

from lintransunet_tpu_torch.cli.postprocess import largest_component_volume
from lintransunet_tpu_torch.core.config import InferenceConfig, add_dataclass_args
from lintransunet_tpu_torch.engine.loop import labels_to_device


def model_parser(config, dim_output: int = 2) -> argparse.ArgumentParser:
    """The parser of ``config``'s fields and the model flags, shared with
    ``inference_multi_classes`` (its deltas: the config's criterion list and
    ``dim_output``)."""
    parser = argparse.ArgumentParser()
    add_dataclass_args(parser, config)
    parser.add_argument("--model_name", type=str, default="MaskTransUnet")
    parser.add_argument("--num_layers",
                        type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(16, 32, 64, 128, 256))
    parser.add_argument("--roi_size_list",
                        type=lambda s: tuple(int(x) for x in s.split(",")),
                        default=(100, 65, 40, 25, 10))
    parser.add_argument("--is_roi_list",
                        type=lambda s: tuple(x.lower() in ("1", "true")
                                             for x in s.split(",")),
                        default=(False, True, True, True, True))
    parser.add_argument("--dim_input", type=int, default=1)
    parser.add_argument("--dim_output", type=int, default=dim_output)
    parser.add_argument("--kernel_size", type=int, default=3)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    return parser


def get_parse():
    parser = model_parser(InferenceConfig())
    parser.add_argument("--attn_layers", type=int, default=8)
    return parser.parse_args()


def _binary_volume(predict, masks, args):
    """(prediction, target) the criterions take, and the export: the blend
    thresholded at ``args.threshold``, the label ids, the class-1 channel as
    a (D, H, W) volume."""
    predict2 = (predict >= args.threshold).float()
    target = labels_to_device(masks, predict.device)
    return predict2, target, predict2[0, 1].cpu().numpy().transpose(2, 0, 1)


def _multi_class_volume(predict, masks, args):
    return largest_component_volume(predict, masks, args.num_classes)


def main(args, multi_class: bool = False):
    """Serve every fold's test volumes from its ``temp_model``.
    ``multi_class`` is ``inference_multi_classes``'s run: its datasets,
    criterions and post-processing."""
    import torch

    from lintransunet_tpu_torch import data, engine
    from lintransunet_tpu_torch.cli.common import (batched_predictions, build_model,
                                                   cli_mesh, make_eval_runner)
    from lintransunet_tpu_torch.core.config import EvalConfig
    from lintransunet_tpu_torch.data.split import load_fold
    from lintransunet_tpu_torch.losses import binary, multiclass

    score_volume = _multi_class_volume if multi_class else _binary_volume
    loss_module = multiclass if multi_class else binary
    dataset_cls = data.MultiClassEvaDataset if multi_class else data.EvaPanCTDataset
    criterions = loss_module.get_criterions(list(args.criterion_list))
    final_loss = [0.0] * len(criterions)
    name_list = sorted(os.listdir(os.path.join(args.dir_data, "image")))
    out_dict = {}

    mesh = cli_mesh(args)
    writer = mesh is None or mesh.rank == 0
    model = build_model(args, None if mesh is None else mesh.device)
    device = next(model.parameters()).device
    eval_cfg = EvalConfig(roi_size=args.roi_size, depth_size=args.depth_size,
                          overlap=args.overlap)
    _, runner = make_eval_runner(model, eval_cfg, sw_batch_size=args.sw_batch_size)

    if args.is_save and writer:
        os.makedirs(args.saved_folder, exist_ok=True)

    for fold_num in range(args.fold_nums):
        _, test_ids = load_fold(args.split_json, fold_num)
        # the reference drops the last test id (inference_embed_attn.py:115)
        test_ids = test_ids[:-1]
        dataset = dataset_cls(root=args.dir_data, depth_size=args.depth_size,
                              ids=test_ids)
        loader = data.DataLoader(dataset, batch_size=args.batch_size,
                                 shuffle=False, num_workers=4)
        model.load_state_dict(engine.restore_params(os.path.join(
            args.pretrained_dir, f"fold_{fold_num}", "temp_model"), device))

        predictions = batched_predictions(loader, runner, mesh)
        if not writer:
            for _ in predictions:  # this rank's share of the volumes
                pass
            continue
        summary_patient_loss = []
        total_loss = [0.0] * len(criterions)
        n = 0
        for i, images, masks, predict in predictions:
            name = name_list[test_ids[i]]
            predict2, target, export = score_volume(predict, masks, args)
            # one host read per volume
            losses = torch.stack([fn(predict2, target).float()
                                  for fn in criterions.values()]).tolist()

            if args.is_save:
                np.save(os.path.join(args.saved_folder,
                                     "{:0>4}".format(name)), export)

            for loss_name, value in zip(criterions, losses):
                print(f"eval patient average {loss_name}", value)
            summary_patient_loss.append(losses)
            total_loss = [t + l for t, l in zip(total_loss, losses)]
            n += 1

        total_loss = [t / max(n, 1) for t in total_loss]
        final_loss = [f + t for f, t in zip(final_loss, total_loss)]
        for loss_name, value in zip(criterions, total_loss):
            print(f"eval total average {loss_name} loss", value)
        out_dict[f"patient_{fold_num}"] = summary_patient_loss
        out_dict[f"summary_{fold_num}"] = total_loss

    if not writer:
        return
    final_loss = [f / args.fold_nums for f in final_loss]
    for loss_name, value in zip(criterions, final_loss):
        print(f"eval final average {loss_name} loss", value)

    with open("summary_4_fold.json", "w") as f:
        json.dump(out_dict, f, indent=4)


if __name__ == "__main__":
    main(get_parse())
