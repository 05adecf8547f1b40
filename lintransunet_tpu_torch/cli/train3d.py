"""Binary CT pancreas training CLI (port of ``lintransunet_tpu/cli/train3d.py``;
mirrors train3D.py:1-297).

The same flags and defaults as the JAX CLI but ``--device`` (the card,
``cuda``, by default; ``--device cpu`` runs on the CPU), and the same
orchestration: K-fold id loading, the per-level criterion schedule, the
exponential deep-supervision weights with their warmup hold, an eval every
``eval_epoch`` epochs with the plateau scheduler and the best-parameters
checkpoint, a full-state checkpoint after each such epoch's training. Every
model of ``Model_Dict`` builds from ``--model_name``. Run:

    python -m lintransunet_tpu_torch.cli.train3d --dir_data <root> --epochs 10

Under ``torchrun`` it trains data-parallel, one process a card, as the JAX
CLI does over every chip (``cli.common.cli_mesh``):

    torchrun --nproc_per_node 4 -m lintransunet_tpu_torch.cli.train3d --dir_data <root>

Each rank loads its own share of the training patients, ``--batch_size``
of them a batch (the global batch is ``--batch_size`` x ranks, JAX's
``batch_size * num_devices``), draws its frames from its own seeded
stream and its dropout masks as its rows of the global batch's (one seed
on every rank, as JAX's step draws the global batch's masks once), and
averages its gradients with the others' every micro-step; the ranks split the eval volumes; only rank 0 writes metrics
and checkpoints.
"""

import argparse
import os

import numpy as np

from lintransunet_tpu_torch.core.config import TrainConfig, add_dataclass_args


def model_parser(config, dim_output: int = 2) -> argparse.ArgumentParser:
    """The parser of ``config``'s fields and the model flags (train3D.py:42-72),
    shared with the multi-class CLIs (their deltas: the config's defaults and
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
    parser.add_argument("--image_crop", type=int, default=512)
    parser.add_argument("--attn_layers", type=int, default=8)
    # eval sliding-window depth (utils_3D_embed_full.py:135 hard-codes 64)
    parser.add_argument("--eval_depth", type=int, default=64)
    return parser


def get_parse():
    return model_parser(TrainConfig()).parse_args()


def _restore(args, fold_num, state, engine):
    """Resume: prefer the full train-state artifact (parameters, optimizer
    moments, step, epoch, best loss and plateau-scheduler state all
    survive, where the reference's params-only resume restarted the
    optimizer, train3D.py:113-117); else the best-parameters artifact.
    Returns (state, aux), aux holding the host-side schedule state."""
    run = os.path.join(args.pretrained_dir, f"fold_{fold_num}")
    full = os.path.join(run, "train_state")
    if os.path.isfile(full):
        return engine.restore_train_state(full, state)
    device = next(state.model.parameters()).device
    state.model.load_state_dict(engine.restore_params(os.path.join(run, "temp_model"), device))
    return state, {}


def setup_rank(args, model, mesh, engine):
    """(writer, model_dir) of this rank: the run's directories and metric
    writer on rank 0, no directory and a ``NullWriter`` elsewhere; every
    rank's parameters made rank 0's."""
    from lintransunet_tpu_torch import parallel
    from lintransunet_tpu_torch.cli.common import run_dirs

    if mesh is not None:
        parallel.replicate(mesh, model)
        if mesh.rank != 0:
            return engine.NullWriter(), None
    log_dir, model_dir = run_dirs(args.log_dir, args.model_dir, args.fold_num)
    return engine.MetricWriter(log_dir), model_dir


def main(args, multi_class: bool = False):
    """Train one fold; returns the final train state. ``multi_class`` is
    ``train3d_multi_class``'s run (train3D_multi_class.py): the multi-class
    datasets, CE + Dice1 + Dice2 on every level, the criterion weights on
    one-hot targets, and model selection on DiceClassLoss + DiceClassLoss2
    of the unthresholded blend."""
    import torch

    from lintransunet_tpu_torch import data, engine, parallel
    from lintransunet_tpu_torch.cli.common import (build_model, cli_mesh,
                                                   get_criterion_list,
                                                   get_multi_criterion_list,
                                                   make_eval_runner)
    from lintransunet_tpu_torch.core.config import EvalConfig
    from lintransunet_tpu_torch.data.split import load_fold
    from lintransunet_tpu_torch.engine import loop
    from lintransunet_tpu_torch.losses import binary, multiclass
    from lintransunet_tpu_torch.models import init_random_

    fold_num = args.fold_num
    batch_size = args.batch_size
    step_times = max(args.num_samples // 3, 1)
    mesh = cli_mesh(args)
    shard = {} if mesh is None else {"rank": mesh.rank, "world_size": mesh.size}

    if multi_class:
        train_cls, test_cls = data.MultiClassPanCTDataset, data.MultiClassEvaDataset
    else:
        train_cls, test_cls = data.IdPosPanCTDataset, data.EvaPanCTDataset
    train_ids, test_ids = load_fold(args.split_json, fold_num)
    train_ds = train_cls(
        root=args.dir_data, depth_size=args.depth_size,
        num_samples=args.num_samples, is_transform=args.is_transform,
        ids=train_ids, image_crop=args.image_crop, seed=args.seed)
    test_ds = test_cls(root=args.dir_data, depth_size=args.depth_size, ids=test_ids)
    train_dl = data.DataLoader(train_ds, batch_size=batch_size, shuffle=True,
                               num_workers=12, seed=args.seed, **shard)
    test_dl = data.DataLoader(test_ds, batch_size=1, shuffle=False, num_workers=2)

    model = build_model(args, None if mesh is None else mesh.device)
    device = next(model.parameters()).device
    init_random_(model, torch.Generator().manual_seed(args.seed))
    state = engine.create_train_state(model, learning_rate=args.learning_rate,
                                      step_times=step_times)
    resume_aux = {}
    if args.is_pretrained:
        state, resume_aux = _restore(args, fold_num, state, engine)

    eval_cfg = EvalConfig(roi_size=args.image_crop,
                          depth_size=getattr(args, "eval_depth", 64))
    if multi_class:
        criterions, eval_criterions = get_multi_criterion_list(
            len(args.num_layers), args.criterion_list, multiclass)
        step_fn = engine.make_train_step(
            model, criterions, criterion_weight=list(args.criterion_weight),
            num_classes=args.num_classes, mesh=mesh)
        eval_args = dict(num_classes=args.num_classes,
                         selection_metrics=("DiceClassLoss", "DiceClassLoss2"))
    else:
        criterions, eval_criterions = get_criterion_list(
            len(args.num_layers), args.criterion_list, binary)
        step_fn = engine.make_train_step(model, criterions, mesh=mesh)
        eval_args = dict(threshold=eval_cfg.threshold)
    _, runner = make_eval_runner(model, eval_cfg)

    scheduler = engine.ReduceLROnPlateau(
        lr=args.learning_rate, factor=args.plateau_factor,
        patience=args.plateau_patience, threshold=args.plateau_threshold,
        cooldown=args.plateau_cooldown, min_lr=args.min_lr)
    if resume_aux.get("scheduler"):
        scheduler = engine.ReduceLROnPlateau(**resume_aux["scheduler"])
        engine.set_learning_rate(state, scheduler.lr)

    writer, model_dir = setup_rank(args, model, mesh, engine)

    dynamic_weight_list = engine.get_dynamic_weight(
        epochs=args.epochs, T=args.weight_T, warmup_step=args.warmup_step,
        weight_list=args.weight_list, initial_weight=args.initial_weight,
        final_weight=args.final_weight)

    best_eval_loss = resume_aux.get("best_eval_loss", float("inf"))
    global_step = resume_aux.get("global_step", 0)
    start_epoch = resume_aux.get("epoch", -1) + 1
    # this rank's own stream of frames; and every dropout's masks, from a
    # generator on the model's device seeded alike on every rank (each mask
    # is the global batch's, this rank's rows kept)
    host_rng = np.random.default_rng(parallel.rank_seed(args.seed, mesh))
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)

    for epoch in range(start_epoch, args.epochs):
        dynamic_weight = dynamic_weight_list[epoch]
        if epoch < args.warmup_step:
            dynamic_weight = dynamic_weight_list[0]

        if epoch % args.eval_epoch == 0:
            eval_loss, global_step = loop.eval_on_epoch(
                runner, test_dl, eval_criterions, writer, global_step, mesh=mesh,
                **eval_args)
            engine.set_learning_rate(state, scheduler.step(eval_loss))
            if eval_loss <= best_eval_loss:
                best_eval_loss = eval_loss
                if model_dir is not None:
                    engine.save_params(os.path.join(model_dir, "temp_model"),
                                       model.state_dict())
                    print("Best eval loss", eval_loss)

        state, train_loss, global_step = loop.train_on_epoch(
            state, train_dl, step_fn, dynamic_weight,
            patient_epochs=args.num_samples, patient_batchsize=batch_size,
            writer=writer, global_step=global_step, rng=host_rng,
            generator=generator)
        writer.add_scalar("lr_rate", engine.get_learning_rate(state),
                          global_step)
        if model_dir is None:
            continue
        print(f"epoch {epoch}: train loss {train_loss:.5f}")
        if epoch % args.eval_epoch == 0:
            # full-state checkpoint AFTER the epoch's training, so that a
            # resume continues exactly at epoch + 1
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
