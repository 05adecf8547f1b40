"""Epoch-level train and eval loops (port of ``lintransunet_tpu/engine/loop.py``).

* ``train_on_epoch`` (utils/utils_3D_embed_full.py:21-116): flatten each
  patient's (batch, samples) frames, run ``patient_epochs`` micro-steps on
  frames resampled from a numpy Generator, log the per-patient mean of the
  loss and of every logged term.
* ``eval_on_epoch`` (utils_3D_embed_full.py:118-169): sliding-window
  inference per volume, the binary path thresholded at 0.5, the criterion
  suite, and the model-selection metric (DiceClassLoss).

The data pipeline yields the JAX package's channels-last arrays;
``to_device`` turns them into the model's (N, C, H, W, D) here, on the way
to the device: in ``train_on_epoch`` and in ``batched_predictions``, which
``eval_on_epoch`` and the inference CLI iterate (over a mesh, a rank moves
only the volumes it serves). The host reads the device once per patient (train) or
volume (eval): a ``float()`` per logged value per micro-step would wait for
the device each time and serialise the host with the card. For the same
reason a patient's frames go to the device in one copy, and each
micro-step picks its frames there.
"""

from typing import Callable, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from lintransunet_tpu_torch import parallel
from lintransunet_tpu_torch.losses.functional import one_hot_map


def to_host(images: np.ndarray) -> torch.Tensor:
    """Channels-last host images (N, H, W, D, C) -> an (N, C, H, W, D) f32
    view of them on the host (a copy only of non-f32 or strided arrays)."""
    return torch.from_numpy(np.ascontiguousarray(images, np.float32)).movedim(-1, 1)


def to_device(images: np.ndarray, device) -> torch.Tensor:
    """Channels-last host images (N, H, W, D, C) -> (N, C, H, W, D) f32 on
    ``device``."""
    return to_host(images).to(device).contiguous()


def labels_to_device(masks: np.ndarray, device) -> torch.Tensor:
    """Host label ids (N, H, W, D) -> int64 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(masks)).to(device).long()


def _model_device(state) -> torch.device:
    return next(state.model.parameters()).device


def train_on_epoch(
    state,
    loader,
    step_fn: Callable,
    dynamic_weight: Sequence[float],
    patient_epochs: int,
    patient_batchsize: int,
    writer,
    global_step: int,
    rng: np.random.Generator,
    generator: Optional[torch.Generator] = None,
):
    """One epoch; returns (state, mean patient loss, new global_step).

    ``step_fn`` is ``engine.make_train_step``'s step, which updates
    ``state`` in place; ``generator`` (a ``torch.Generator`` on the model's
    device) is the one every dropout of every micro-step draws from."""
    device = _model_device(state)
    dyn_w = torch.as_tensor(dynamic_weight, dtype=torch.float32, device=device)
    batch_level_loss = 0.0
    n_batches = 0

    for i, (images, masks) in enumerate(loader):
        # (B, num_samples, H, W, D, 1) -> (frames, H, W, D, 1)
        images = images.reshape((-1,) + images.shape[2:])
        masks = masks.reshape((-1,) + masks.shape[2:])
        frames_x = to_device(images, device)
        frames_y = labels_to_device(masks, device)

        pending, names = [], []
        for _ in range(patient_epochs):
            idx = rng.integers(0, images.shape[0], size=patient_batchsize)
            batch_x = torch.stack([frames_x[int(k)] for k in idx])
            batch_y = torch.stack([frames_y[int(k)] for k in idx])
            loss, logs = step_fn(state, batch_x, batch_y, dyn_w, generator)
            names = sorted(logs)  # JAX's order: a jitted dict comes back sorted
            pending.append(torch.stack([loss.float()] + [logs[k].float() for k in names]))

        fetched = torch.stack(pending).tolist()  # the patient's one host read
        patient_loss = sum(row[0] for row in fetched) / patient_epochs
        writer.add_scalar("train/total_loss", patient_loss, global_step + i)
        for j, name in enumerate(names, start=1):
            value = sum(row[j] for row in fetched) / patient_epochs
            writer.add_scalar(f"train/{name}", value, global_step + i)
        batch_level_loss += patient_loss
        n_batches += 1

    global_step += max(n_batches - 1, 0)
    return state, batch_level_loss / max(n_batches, 1), global_step


def batched_predictions(loader, runner, mesh=None) -> Iterator[
        Tuple[int, np.ndarray, np.ndarray, torch.Tensor]]:
    """Yield (index, images, masks, predict) per eval volume: the loader's
    channels-last host arrays with the (batch, samples) dims flattened, and
    the runner's (N, C, H, W, D) f32 blend on the runner's device (a runner
    built without one raises: ``make_eval_runner`` gives it the model's).

    With ``mesh`` (every rank iterating the same loader), volumes go through
    ``runner.run_batch`` mesh-size at a time, each rank blending its own; a
    short last group is padded with its first volume, whose extra output is
    discarded. Every rank yields every volume, as without a mesh."""
    if runner.device is None:
        raise ValueError("the runner has no device; build it with make_eval_runner")
    items = ((i, images.reshape((-1,) + images.shape[2:]), masks.reshape((-1,) + masks.shape[2:]))
             for i, (images, masks) in enumerate(loader))
    if mesh is None:
        for i, images, masks in items:
            yield i, images, masks, runner(to_device(images, runner.device))
        return

    def flush(group):
        # host views: run_batch moves this rank's volumes to its card and
        # reads only the shapes of the others
        vols = [to_host(images) for _, images, _ in group]
        vols += [vols[0]] * ((-len(vols)) % mesh.size)
        preds = runner.run_batch(vols, mesh=mesh)
        return [(i, images, masks, preds[j]) for j, (i, images, masks) in enumerate(group)]

    group = []
    for item in items:
        group.append(item)
        if len(group) == mesh.size:
            yield from flush(group)
            group = []
    if group:
        yield from flush(group)


def eval_on_epoch(
    runner,
    loader,
    criterions: Dict[str, Callable],
    writer,
    global_step: int,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    selection_metrics: Sequence[str] = ("DiceClassLoss",),
    mesh=None,
):
    """Sliding-window eval; returns (selection metric value, global_step+1).

    ``runner`` is a ``SlidingWindowRunner`` over the eval forward; it
    returns (N, C, H, W, D) f32 on the model's device. The binary path
    thresholds the blend at 0.5 (utils_3D_embed_full.py:153); the
    multi-class eval defines a threshold but never applies it
    (utils_3D_multi_class.py:168) and gives its criterions one-hot targets
    (:174-180).

    With ``mesh`` the ranks split the volumes (``batched_predictions``),
    every rank scores every volume, and the selection metric is averaged
    over the group, so that every rank's plateau scheduler sees one value."""
    totals = {name: 0.0 for name in criterions}
    n = 0
    for _, _, masks, predict in batched_predictions(loader, runner, mesh):
        target = labels_to_device(masks, predict.device)
        if num_classes is None:
            predict = (predict >= threshold).float()
        else:
            target = one_hot_map(target, num_classes)
        values = torch.stack([fn(predict, target).float()
                              for fn in criterions.values()]).tolist()
        for name, v in zip(criterions, values):
            totals[name] += v
        n += 1

    out_loss = 0.0
    total = sum(totals.values()) / max(n, 1)
    writer.add_scalar("eval/total_loss", total, global_step)
    for name, value in totals.items():
        mean = value / max(n, 1)
        if name in selection_metrics:
            out_loss += mean
        writer.add_scalar(f"eval/{name}", mean, global_step)
    if mesh is not None:
        mean = torch.tensor([out_loss], dtype=torch.float64, device=mesh.device)
        out_loss = parallel.all_reduce_mean(mesh, [mean])[0].item()
    return out_loss, global_step + 1
