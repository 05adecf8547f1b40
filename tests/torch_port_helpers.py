"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Parameters come from the flax tree's SHAPES (``jax.eval_shape`` of
``init``, no real init: the unjitted init of the 5-level model takes more
than a minute on the CPU) filled with seeded numpy normals; the same tree
goes to the JAX module and, through ``from_flax``, to the port.

The data-parallel tests' ranks (``dp_worker``, ``cli_worker``,
``tracing_worker``) live here,
where ``torch.multiprocessing.spawn`` can pickle them by name; they import
torch and the port only (jax is imported inside ``random_params``).
"""

import os
import types

import numpy as np
import torch
import torch.distributed as dist

from lintransunet_tpu_torch.compat import from_flax

SMALL = dict(
    num_layers=(8, 16, 32, 32, 64),
    roi_size_list=(16, 12, 8, 6, 4),
    is_roi_list=(False, True, True, True, True),
    dim_input=1,
    dim_output=2,
)


def random_params(module, *args, seed=0, scale=0.1, **kwargs):
    """numpy params tree of ``module.init(key, *args, **kwargs)``'s shapes."""
    import jax

    shapes = jax.eval_shape(
        lambda key: module.init(key, *args, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        shapes["params"])


def load_port(port_module, params):
    """Load the flax ``params`` into ``port_module`` (strict: every key and
    shape must match) and put it in eval mode."""
    port_module.load_state_dict(from_flax(params), strict=True)
    return port_module.eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def worst_grad_error(got, want):
    """(name, error) of the gradient farthest from ``want``: max |got - want|
    over max |want|, or over 1e-1 of the largest gradient where the gradient
    vanishes (max |want| below 1e-5 of it: rounding noise), so that 1e-4 on
    that share is 1e-5 of the largest gradient; where every gradient is 0,
    max |got - want| itself."""
    top = max(w.abs().max().item() for w in want.values())
    errors = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        if top == 0:
            scale = 1.0
        elif scale < 1e-5 * top:
            scale = 1e-1 * top
        errors[name] = (got[name] - w).abs().max().item() / scale
    return max(errors.items(), key=lambda kv: kv[1])


def head_split(x):
    """(B, H, N, d) numpy -> the same values as the port's attention layers
    pass them: the head-split view ``view(B, N, H, d).transpose(1, 2)`` of a
    contiguous (B, N, H*d) tensor."""
    b, h, n, d = x.shape
    return t(x.transpose(0, 2, 1, 3).reshape(b, n, h * d)).view(b, n, h, d).transpose(1, 2)


# The binary CLIs' tiny configuration and workspace (tests/test_torch_cli.py,
# tests/test_torch_parallel.py)
CLI_TINY = dict(model_name="MaskTransUnet", num_layers=(8, 32), roi_size_list=(8, 4),
                is_roi_list=(False, True), dim_input=1, dim_output=2, kernel_size=3,
                compute_dtype="float32", attn_layers=1)


def cli_workspace(root, multi_class=False):
    """Four (8, 32, 32) HU volumes with a label box (and with
    ``multi_class`` a class-2 box inside it) under ``root``/data and a
    2-fold split by the port's split tool."""
    import sys

    from lintransunet_tpu_torch.cli import split_dataset

    data = os.path.join(root, "data")
    os.makedirs(os.path.join(data, "image"))
    os.makedirs(os.path.join(data, "label"))
    rng = np.random.default_rng(1)
    for i in range(4):
        img = rng.normal(40.0, 60.0, (8, 32, 32)).astype(np.float32)
        lbl = np.zeros((8, 32, 32), np.uint8)
        lbl[2:5, 8:20, 10:22] = 1
        if multi_class:
            lbl[3:5, 12:16, 12:16] = 2
        np.save(os.path.join(data, "image", f"{i:04d}.npy"), img)
        np.save(os.path.join(data, "label", f"{i:04d}.npy"), lbl)
    split = os.path.join(root, "split.json")
    saved = sys.argv
    sys.argv = ["prog", "--dir_data", data, "--k_folds", "2", "--out", split]
    try:
        split_dataset.main()
    finally:
        sys.argv = saved
    return {"root": root, "data": data, "split": split}


def cli_train_args(ws, tmp):
    return types.SimpleNamespace(
        dir_data=ws["data"], is_transform=True, split_ratio=0.9,
        is_pretrained=False, pretrained_dir="", batch_size=1, depth_size=8,
        num_samples=2, device="cpu", epochs=2, eval_epoch=2,
        log_dir=os.path.join(tmp, "runs"), model_dir=os.path.join(tmp, "out"),
        criterion_list=("CrossEntroLoss", "DiceClassLoss"),
        criterion_weight=(1.0, 1.0),
        weight_list=(0.1, 1.0), final_weight=(2.0, 1.0),
        initial_weight=(0.1, 1.0), fold_num=0, split_json=ws["split"],
        learning_rate=1e-3, plateau_factor=0.8, plateau_patience=5,
        plateau_threshold=1e-2, plateau_cooldown=1, min_lr=1e-7,
        warmup_step=1, weight_T=12.0, num_classes=2, seed=0,
        image_crop=16, eval_depth=8, **CLI_TINY)


def cli_infer_args(ws, pretrained_dir, saved_folder):
    return types.SimpleNamespace(
        dir_data=ws["data"], pretrained_dir=pretrained_dir,
        batch_size=1, depth_size=8, roi_size=16, sw_batch_size=1, overlap=0.6,
        threshold=0.5,
        criterion_list=("DiceClassLoss", "Recall", "Precision", "LocalizationLoss"),
        is_save=True, saved_folder=saved_folder, fold_nums=1,
        split_json=ws["split"], device="cpu", **CLI_TINY)


# The data-parallel step's tiny model: no ROI level, since a DP step and the
# joined batch's step differ at the rounding level, which can move an ROI
# box by a pixel (the boxes are per sample, so they add nothing that DP must
# hold); dropout 0 against JAX (whose masks are other random numbers), and
# a case's own rate against the joined batch.
DP_TINY = dict(num_layers=(8, 32), roi_size_list=(8, 4), is_roi_list=(False, False),
               dim_input=1, n_layers=1, dropout=0.0)
# one rank's shard of activations whose dropout masks the ranks draw
DP_MASK_SHAPE = (1, 8, 4, 4, 2)


def _init_rank(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)


def _dp_cases(mesh, spec):
    """Every criterion's DP step on this rank's shard, and the step_times 2
    accumulation: {key: (loss, logs, grads, params, [each micro-step's
    group-averaged gradients as the optimizer received them])}."""
    from lintransunet_tpu_torch import engine, parallel
    from lintransunet_tpu_torch.engine import train
    from lintransunet_tpu_torch.losses import binary, multiclass
    from lintransunet_tpu_torch.models import MaskTransUnet

    received = []
    apply_gradients = train.apply_gradients

    def recording(state):
        received.append({n: p.grad.clone() for n, p in state.model.named_parameters()})
        apply_gradients(state)

    train.apply_gradients = recording
    out = {}
    for key, (kind, names, step_times, dropout) in spec["cases"].items():
        multi = kind == "multi"
        model = MaskTransUnet(**{**DP_TINY, "dropout": dropout}, dim_output=3 if multi else 2,
                              device="cpu")
        model.load_state_dict(spec["params"][kind])
        module = multiclass if multi else binary
        criterions = [module.get_criterions(list(names))] * len(DP_TINY["num_layers"])
        step = engine.make_train_step(
            model, criterions, criterion_weight=[1.0] * len(names) if multi else None,
            num_classes=3 if multi else None, mesh=mesh)
        state = engine.create_train_state(model, spec["lr"], step_times)
        # one dropout seed on every rank: each mask is the global batch's
        generator = torch.Generator().manual_seed(spec["dropout_seed"])
        received.clear()
        for images, labels in spec["batches"][kind][:step_times]:
            loss, logs = step(state, parallel.shard_batch(mesh, images),
                              parallel.shard_batch(mesh, labels), spec["dynamic_weight"],
                              generator)
        out[key] = (loss, logs, {n: p.grad.clone() for n, p in model.named_parameters()},
                    {n: p.detach().clone() for n, p in model.named_parameters()},
                    list(received))
    train.apply_gradients = apply_gradients
    return out


def solid_block_step(spec, shard):
    """``SolidBlock``'s training forward and backward on the ``shard``
    (rank, size) of ``spec``'s joined batch (rows split evenly), under
    ``dropout_generator``'s shard as a DP step runs it: {output, the input's
    gradient, each parameter's gradient, the running statistics}, the
    gradients of sum(output * spec["cotangent"]) over the shard's rows."""
    from lintransunet_tpu_torch import models
    from lintransunet_tpu_torch.models import blocks

    rank, size = shard
    rows = spec["x"].shape[0] // size
    part = slice(rank * rows, (rank + 1) * rows)
    block = models.SolidBlock(spec["x"].shape[-1])
    block.load_state_dict(spec["state"], strict=True)
    block.train()
    x = spec["x"][part].clone().requires_grad_(True)
    with blocks.dropout_generator(None, shard):
        out = block(x)
    (out * spec["cotangent"][part]).sum().backward()
    bn = block.solid_layer_1
    return {"out": out.detach(), "x_grad": x.grad,
            "grads": {n: p.grad for n, p in block.named_parameters()},
            "running": (bn.running_mean.clone(), bn.running_var.clone())}


def dp_worker(rank, world, store, workdir):
    """One rank of tests/test_torch_parallel.py: the DP train steps of
    ``spec.pt``, run_batch and batched_predictions over its volumes, the
    rank's dropout masks (an element mask, then a channel mask, of a
    one-sample shard), ``SolidBlock``'s training call on its shard
    (``solid_block_step``), and the collectives; writes ``rank<r>.pt``."""
    from lintransunet_tpu_torch import engine, parallel
    from lintransunet_tpu_torch.engine import loop
    from lintransunet_tpu_torch.models import blocks

    _init_rank(rank, world, store)
    try:
        mesh = parallel.make_mesh(device="cpu")
        spec = torch.load(os.path.join(workdir, "spec.pt"))
        result = {"mesh": (mesh.rank, mesh.size, str(mesh.device)),
                  "steps": _dp_cases(mesh, spec)}

        generator = torch.Generator().manual_seed(spec["dropout_seed"])
        with blocks.dropout_generator(generator, (mesh.rank, mesh.size)):
            result["masks"] = [blocks.dropout(torch.ones(DP_MASK_SHAPE), 0.5, True),
                               blocks.dropout(torch.ones(DP_MASK_SHAPE), 0.5, True,
                                              channel=True)]

        runner = engine.SlidingWindowRunner(
            lambda x: torch.cat([x + x.mean(dim=(2, 3, 4), keepdim=True), -x], dim=1),
            spec["roi"], 2, overlap=0.6, device="cpu")
        volumes = spec["volumes"]
        result["run_batch"] = runner.run_batch(volumes + volumes[:1], mesh=mesh)
        loader = [(v.movedim(1, -1).numpy()[:, None], np.zeros(1)) for v in volumes]
        result["batched"] = [(i, predict) for i, _, _, predict in
                             loop.batched_predictions(loader, runner, mesh)]

        result["solid"] = solid_block_step(spec["solid"], (mesh.rank, mesh.size))

        module = torch.nn.Linear(3, 2)
        torch.manual_seed(rank)
        module.reset_parameters()
        result["replicated"] = parallel.replicate(mesh, module).state_dict()
        result["mean"] = parallel.all_reduce_mean(
            mesh, [torch.full((2,), float(rank)), torch.tensor([rank], dtype=torch.float64)])
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def monai_train_args(ws, tmp):
    """``train3d_monai_version``'s run of the tiny model at 3 classes."""
    from lintransunet_tpu_torch.cli.train3d_multi_class import MULTI_CLASS

    args = cli_train_args(ws, tmp)
    vars(args).update(MULTI_CLASS, dim_output=3, epochs=1, eval_epoch=1)
    return args


def cli_worker(rank, world, store, workdir, cli):
    """One rank of a CLI run inside a caller-initialised group, over the CLI
    workspace in ``workdir``: ``cli`` "train3d" (then ``inference_embed_attn``
    on its checkpoint) or "monai" (``train3d_monai_version``); writes the
    rank's final parameters to ``params<r>.pt``."""
    from lintransunet_tpu_torch.cli import (inference_embed_attn, train3d,
                                            train3d_monai_version)

    _init_rank(rank, world, store)
    try:
        ws = torch.load(os.path.join(workdir, "workspace.pt"))
        os.chdir(workdir)  # the inference CLI writes its summary where it runs
        if cli == "monai":
            state = train3d_monai_version.main(monai_train_args(ws, workdir))
        else:
            state = train3d.main(cli_train_args(ws, workdir))
        torch.save(state.model.state_dict(), os.path.join(workdir, f"params{rank}.pt"))
        if cli == "train3d":
            dist.barrier()  # rank 0's run directory exists
            out = os.path.join(workdir, "out")
            run = os.path.join(out, os.listdir(out)[0])
            inference_embed_attn.main(cli_infer_args(ws, run, os.path.join(workdir, "pred")))
    finally:
        dist.destroy_process_group()


def tracing_worker(rank, world, store, workdir):
    """One rank of tests/test_torch_tracing.py: a DP micro-step of the tiny
    model under a host-only ``torch.profiler``; writes the rank's ``ltu.*``
    ranges, (name, start ns, end ns), to ``spans<r>.pt``."""
    from torch.profiler import ProfilerActivity, profile

    from lintransunet_tpu_torch import engine, parallel
    from lintransunet_tpu_torch.cli.common import get_criterion_list
    from lintransunet_tpu_torch.models import MaskTransUnet

    _init_rank(rank, world, store)
    try:
        mesh = parallel.make_mesh(device="cpu")
        torch.manual_seed(0)
        model = MaskTransUnet(**DP_TINY, dim_output=2, device="cpu")
        parallel.replicate(mesh, model)
        criterions, _ = get_criterion_list(len(DP_TINY["num_layers"]),
                                           ("CrossEntroLoss", "DiceClassLoss"))
        step = engine.make_train_step(model, criterions, mesh=mesh)
        state = engine.create_train_state(model, 1e-4)
        images = torch.randn(1, 1, 16, 16, 4, generator=torch.Generator().manual_seed(rank))
        labels = torch.zeros(1, 16, 16, 4, dtype=torch.long)
        labels[:, 4:12, 4:12, 1:3] = 1
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, images, labels, torch.ones(len(DP_TINY["num_layers"])))
        spans = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                 if e.name().startswith("ltu.")]
        torch.save(spans, os.path.join(workdir, f"spans{rank}.pt"))
    finally:
        dist.destroy_process_group()
