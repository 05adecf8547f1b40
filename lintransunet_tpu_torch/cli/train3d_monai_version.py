"""Cached-pipeline training CLI (port of
``lintransunet_tpu/cli/train3d_monai_version.py``; mirrors
train3D_monai_version.py:1-302).

The multi-class model and criterions over ``CachePanDataset`` (the
deterministic preprocessing cached in RAM at construction, the random
crops, flips and rot90 per access) with the MONAI loop's semantics: ONE
optimiser step per batch, no inner patient loop and no gradient
accumulation (utils/utils_3D_monai.py:45-105), hence its own epoch loop
here. The same flags and defaults as the JAX CLI, and ``--device`` (the
card, ``cuda``, by default; ``--device cpu`` runs on the CPU). Run:

    python -m lintransunet_tpu_torch.cli.train3d_monai_version --dir_data <root>

Under ``torchrun`` it trains data-parallel as ``train3d`` does: each rank's
loader holds its share of the patients, padded by wrap-around so that every
rank takes the same number of equal steps (the JAX CLI pads a ragged global
batch the same way, train3d_monai_version.py:178-185).
"""

import os

from lintransunet_tpu_torch.cli import train3d
from lintransunet_tpu_torch.cli.train3d_multi_class import MULTI_CLASS
from lintransunet_tpu_torch.core.config import TrainConfig


def get_parse():
    parser = train3d.model_parser(TrainConfig(**MULTI_CLASS), dim_output=3)
    # Spacingd / Orientationd controls (CT_pancreas_monai.py:47-48 applies
    # both unconditionally; NIfTI affines override source_spacing/axcodes)
    parser.add_argument("--no_resample", action="store_true",
                        help="skip Spacingd resampling to pixdim")
    parser.add_argument("--no_orient", action="store_true",
                        help="skip Orientationd-to-RAS")
    parser.add_argument("--source_spacing",
                        type=lambda s: tuple(float(x) for x in s.split(",")),
                        default=(1.0, 1.0, 1.0),
                        help="per-axis mm spacing of .npy sources")
    parser.add_argument("--source_axcodes", type=str, default="SRA",
                        help="anatomical axis codes of .npy sources")
    return parser.parse_args()


def main(args):
    import torch

    from lintransunet_tpu_torch import data, engine
    from lintransunet_tpu_torch.cli.common import (build_model, cli_mesh,
                                                   get_multi_criterion_list,
                                                   make_eval_runner)
    from lintransunet_tpu_torch.core.config import EvalConfig
    from lintransunet_tpu_torch.data.split import load_fold
    from lintransunet_tpu_torch.engine import loop
    from lintransunet_tpu_torch.losses import multiclass
    from lintransunet_tpu_torch.models import init_random_

    fold_num = args.fold_num
    batch_size = args.batch_size
    mesh = cli_mesh(args)
    shard = {} if mesh is None else {"rank": mesh.rank, "world_size": mesh.size}

    train_ids, test_ids = load_fold(args.split_json, fold_num)
    prep = dict(
        resample=not getattr(args, "no_resample", False),
        orient=not getattr(args, "no_orient", False),
        source_spacing=getattr(args, "source_spacing", (1.0, 1.0, 1.0)),
        source_axcodes=getattr(args, "source_axcodes", "SRA"))
    train_ds = data.CachePanDataset(root=args.dir_data, depth_size=args.depth_size,
                                    num_samples=1, ids=train_ids,
                                    image_crop=args.image_crop, seed=args.seed, **prep)
    test_ds = data.EvaPanDataset(root=args.dir_data, depth_size=args.depth_size,
                                 ids=test_ids, **prep)
    train_dl = data.DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                               num_workers=8, seed=args.seed, **shard)
    test_dl = data.DataLoader(test_ds, batch_size=1, shuffle=False, num_workers=2)

    model = build_model(args, None if mesh is None else mesh.device)
    device = next(model.parameters()).device
    init_random_(model, torch.Generator().manual_seed(args.seed))
    # one step per batch: no accumulation (utils_3D_monai.py:103-105)
    state = engine.create_train_state(model, learning_rate=args.learning_rate,
                                      step_times=1)
    resume_aux = {}
    if args.is_pretrained:
        state, resume_aux = train3d._restore(args, fold_num, state, engine)

    criterions, eval_criterions = get_multi_criterion_list(
        len(args.num_layers), args.criterion_list, multiclass)
    step_fn = engine.make_train_step(
        model, criterions, criterion_weight=list(args.criterion_weight),
        num_classes=args.num_classes, mesh=mesh)

    eval_cfg = EvalConfig(roi_size=args.image_crop,
                          depth_size=getattr(args, "eval_depth", 64))
    _, runner = make_eval_runner(model, eval_cfg)

    scheduler = engine.ReduceLROnPlateau(
        lr=args.learning_rate, factor=args.plateau_factor,
        patience=args.plateau_patience, threshold=args.plateau_threshold,
        cooldown=args.plateau_cooldown, min_lr=args.min_lr)
    if resume_aux.get("scheduler"):
        scheduler = engine.ReduceLROnPlateau(**resume_aux["scheduler"])
        engine.set_learning_rate(state, scheduler.lr)

    writer, model_dir = train3d.setup_rank(args, model, mesh, engine)

    dynamic_weight_list = engine.get_dynamic_weight(
        epochs=args.epochs, T=args.weight_T, warmup_step=args.warmup_step,
        weight_list=args.weight_list, initial_weight=args.initial_weight,
        final_weight=args.final_weight)

    best_eval_loss = resume_aux.get("best_eval_loss", float("inf"))
    global_step = resume_aux.get("global_step", 0)
    start_epoch = resume_aux.get("epoch", -1) + 1
    # every dropout draws from this generator on the model's device, seeded
    # alike on every rank (each mask is the global batch's, this rank's rows
    # kept)
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    for epoch in range(start_epoch, args.epochs):
        dynamic_weight = dynamic_weight_list[epoch]
        if epoch < args.warmup_step:
            dynamic_weight = dynamic_weight_list[0]
        dyn_w = torch.as_tensor(dynamic_weight, dtype=torch.float32, device=device)

        if epoch % args.eval_epoch == 0:
            eval_loss, global_step = loop.eval_on_epoch(
                runner, test_dl, eval_criterions, writer, global_step,
                num_classes=args.num_classes,
                selection_metrics=("DiceClassLoss", "DiceClassLoss2"), mesh=mesh)
            engine.set_learning_rate(state, scheduler.step(eval_loss))
            if eval_loss <= best_eval_loss:
                best_eval_loss = eval_loss
                if model_dir is not None:
                    engine.save_params(os.path.join(model_dir, "temp_model"),
                                       model.state_dict())
                    print("Best eval loss", eval_loss)

        losses = []
        for images, masks in train_dl:
            images = images.reshape((-1,) + images.shape[2:])
            masks = masks.reshape((-1,) + masks.shape[2:])
            loss, _ = step_fn(state, loop.to_device(images, device),
                              loop.labels_to_device(masks, device), dyn_w, generator)
            losses.append(loss)
        # the epoch's one host read
        epoch_loss = torch.stack(losses).sum().item() if losses else 0.0
        writer.add_scalar("train/total_loss", epoch_loss / max(len(losses), 1),
                          global_step)
        global_step += 1
        if model_dir is None:
            continue
        print(f"epoch {epoch}: train loss {epoch_loss / max(len(losses), 1):.5f}")
        if epoch % args.eval_epoch == 0:
            engine.save_train_state(
                os.path.join(model_dir, "train_state"), state,
                aux={"epoch": epoch, "best_eval_loss": best_eval_loss,
                     "global_step": global_step,
                     "scheduler": scheduler.state_dict()})

    if model_dir is not None:
        engine.save_checkpoint(os.path.join(model_dir, "model"),
                               {"params": model.state_dict()})
    writer.close()
    return state


if __name__ == "__main__":
    main(get_parse())
