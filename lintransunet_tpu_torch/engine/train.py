"""Training step and eval forward (port of ``lintransunet_tpu/engine/train.py``).

* ``deep_supervision_loss``: the deep-supervision loss over the decoder's
  mask pyramid with the reference's max-pool label-pyramid schedule
  (utils_3D_embed_full.py:64, 73-76);
* ``make_optimizer``: AdamW with weight decay 0.01 on every parameter, as
  ``optax.adamw`` without a mask;
* ``step_times`` accumulation with ``optax.MultiSteps`` semantics: the
  running (Welford) mean of k micro-step gradients, one optimizer update
  on the k-th, parameters untouched in between;
* bf16 compute with f32 parameters, as in JAX: the model casts the input
  and every parameter to its compute dtype, and autograd carries the
  gradients back to the f32 parameters. No loss scaling, as in JAX.

The step updates its ``TrainState`` in place (JAX's returns a new one) and
leaves each parameter's ``.grad`` holding the step's gradient until the
next step, so a caller can inspect it.

Data parallelism (``make_train_step(..., mesh=)``): each rank runs the loss
and backward on its own shard, and one ``all_reduce`` averages the
gradients, the loss and the logs. The mean over ranks of per-shard means of
per-sample terms is the global batch's mean when the shards are equal, so
the step then equals the single-process step on the joined batch, as JAX's
SPMD step does. A criterion whose value couples the samples of a batch
(``losses.multiclass.ClassifyLoss``: a ratio of batch sums) reduces its
coupling term over the group itself (its ``over_group``). Dropout draws
each mask at the global batch's shape and keeps this rank's rows
(``blocks.dropout_generator``'s shard), as JAX's SPMD step draws the global
batch's masks once: with every rank's generator seeded alike, a DP step
equals the joined batch's at any dropout.

A step runs in the profiler span ``step`` (``utils.profiling.span``; its
``seq`` the state's micro-step count), with ``step.forward`` (the model and
the loss), ``step.backward``, ``step.allreduce`` (under a mesh) and
``step.update`` inside; ``apply_gradients`` splits the update into
``update.accumulate`` and ``update.optimizer``.
"""

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn

from lintransunet_tpu_torch import parallel
from lintransunet_tpu_torch.losses.functional import one_hot_map
from lintransunet_tpu_torch.ops.pool import max_pool3d
from lintransunet_tpu_torch.utils import profiling


@dataclasses.dataclass
class TrainState:
    """What a resume needs: the model (its parameters), the optimizer (its
    moments), the micro-step count ``step`` (JAX ``TrainState.step``), and
    the accumulation state of ``optax.MultiSteps``: ``mini_step``,
    ``gradient_step`` and ``acc_grads`` (the running mean of the micro-step
    gradients, f32, None while ``step_times`` is 1)."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step_times: int = 1
    step: int = 0
    mini_step: int = 0
    gradient_step: int = 0
    acc_grads: Optional[List[torch.Tensor]] = None


def make_optimizer(params, learning_rate: float,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW (torch defaults, train3D.py:193): betas (0.9, 0.999), eps 1e-8,
    decoupled weight decay on every parameter."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=weight_decay)


def create_train_state(model: nn.Module, learning_rate: float = 1e-4,
                       step_times: int = 1) -> TrainState:
    """The train state of ``model`` as it stands (its parameters are the
    initial ones: ``init_random_`` or a loaded state_dict)."""
    if step_times < 1:
        raise ValueError(f"step_times must be >= 1, not {step_times}")
    return TrainState(model, make_optimizer(model.parameters(), learning_rate),
                      step_times)


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Write a new LR into every parameter group (the plateau scheduler's hook)."""
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


def _with_grads(model: nn.Module) -> List[nn.Parameter]:
    """The trainable parameters, each given a zero ``.grad`` where it has
    none (a dead bridge's), so that the update and the all-reduce see every
    parameter."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def apply_gradients(state: TrainState) -> None:
    """One micro-step on the gradients in each parameter's ``.grad``:
    ``optax.MultiSteps(adamw, every_k_schedule=step_times)``'s update."""
    params = _with_grads(state.model)
    state.step += 1
    if state.step_times == 1:
        with profiling.span("update.optimizer"):
            state.optimizer.step()
        state.gradient_step += 1
        return
    with profiling.span("update.accumulate"), torch.no_grad():
        if state.acc_grads is None:
            state.acc_grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        n = state.mini_step
        for acc, p in zip(state.acc_grads, params):
            acc.add_((p.grad.float() - acc) / (n + 1))
        state.mini_step = (n + 1) % state.step_times
        if state.mini_step:
            return
        for acc, p in zip(state.acc_grads, params):  # the mean goes to the optimizer
            p.grad.copy_(acc)
            acc.zero_()
    with profiling.span("update.optimizer"):
        state.optimizer.step()
    state.gradient_step += 1


def label_pyramid_kernel(level: int):
    """Pool kernel applied after deep-supervision level ``level``
    (utils_3D_embed_full.py:73-76): even levels pool (2, 2, 2), odd
    (2, 2, 1); the pyramid starts from one (2, 2, 1) pool of the
    full-resolution labels (:64)."""
    return (2, 2, 2) if level % 2 == 0 else (2, 2, 1)


def deep_supervision_loss(out: torch.Tensor, mask_list: Sequence[torch.Tensor],
                          labels: torch.Tensor,
                          criterions: Sequence[Dict[str, Callable]],
                          dynamic_weight,
                          criterion_weight: Optional[Sequence[float]] = None,
                          num_classes: Optional[int] = None):
    """(total weighted loss, {f"{name} layer{i}": value}).

    ``criterions[level]`` follows the reference's indexing: level L-1 is the
    full-resolution output, level L-1-k supervises ``mask_list[-k]``
    (utils_3D_embed_full.py:66-82). ``labels``: (N, H, W, D) integer ids;
    ``out`` and the masks are channels-first probabilities. With
    ``num_classes``, targets are channels-first one-hots and each criterion
    is scaled by ``criterion_weight`` (utils_3D_multi_class.py:84, 96);
    otherwise the raw ids are passed (the binary path).
    """
    n_levels = len(criterions)
    temp = max_pool3d(labels.float()[:, None], (2, 2, 1), (2, 2, 1))
    weights_k = torch.as_tensor(dynamic_weight, dtype=torch.float32, device=out.device)

    total = torch.zeros((), dtype=torch.float32, device=out.device)
    logs: Dict[str, torch.Tensor] = {}
    for k in range(n_levels):
        level_criterions = criterions[n_levels - 1 - k]
        if k == 0:
            pred, target_ids = out, labels
        else:
            pred, target_ids = mask_list[-k], temp[:, 0]
        target = target_ids if num_classes is None else one_hot_map(target_ids, num_classes)

        level_total = torch.zeros((), dtype=torch.float32, device=out.device)
        weights = criterion_weight or [1.0] * len(level_criterions)
        for (name, fn), w in zip(level_criterions.items(), weights):
            value = fn(pred, target) * (w if num_classes is not None else 1.0)
            logs[f"{name} layer{n_levels - 1 - k}"] = value
            level_total = level_total + value
        total = total + level_total * weights_k[k]

        if k != 0 and k < n_levels - 1:
            temp = max_pool3d(temp, label_pyramid_kernel(k), label_pyramid_kernel(k))
    return total, logs


def _over_group(criterions, mesh):
    """Each criterion that couples a batch's samples, bound to the group."""
    return [{name: (functools.partial(fn.over_group, mesh) if hasattr(fn, "over_group")
                    else fn) for name, fn in level.items()} for level in criterions]


def make_train_step(model: nn.Module, criterions: Sequence[Dict[str, Callable]],
                    criterion_weight: Optional[Sequence[float]] = None,
                    num_classes: Optional[int] = None,
                    mesh: Optional[parallel.Mesh] = None) -> Callable:
    """``step(state, images, labels, dynamic_weight, generator) -> (loss,
    logs)``; updates ``state`` in place.

    images: (N, C, H, W, D) on the model's device; labels: (N, H, W, D)
    integer ids; dynamic_weight: (L,) per-level weights; generator: a
    ``torch.Generator`` on the model's device that every dropout draws
    from (as JAX's step takes ``rng``), or None for the global one.
    ``step.loss_fn(images, labels, dynamic_weight, generator)`` is the loss
    alone, (loss, logs), for a caller that differentiates it itself.

    With ``mesh`` (``parallel.make_mesh``), images and labels are this
    rank's shard of the global batch (every rank's the same size) and the
    step averages the gradients over the group before the update (each
    micro-step's, under accumulation); it returns the loss and logs
    averaged over the group, the global batch's, on every rank. The
    parameters must start equal on every rank (``parallel.replicate``), and
    so must ``generator``: each dropout draws the global batch's mask and
    keeps this rank's rows.
    """
    from lintransunet_tpu_torch.models.blocks import dropout_generator
    from lintransunet_tpu_torch.models.registry import MaskTransUnet

    aux = {"return_aux": True} if isinstance(model, MaskTransUnet) else {}
    if mesh is not None:
        criterions = _over_group(criterions, mesh)

    shard = (0, 1) if mesh is None else (mesh.rank, mesh.size)

    def loss_fn(images, labels, dynamic_weight, generator=None):
        with dropout_generator(generator, shard):
            # as JAX's step: every model's train output is unpacked as
            # (probabilities, mask_list); a model that returns probabilities
            # alone does not train here, in either package
            out, mask_list = model(images, **aux)
        return deep_supervision_loss(out, mask_list, labels, criterions,
                                     dynamic_weight, criterion_weight, num_classes)

    def step(state: TrainState, images, labels, dynamic_weight, generator=None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        with profiling.span("step", state.step):
            model.train()
            state.optimizer.zero_grad(set_to_none=True)
            with profiling.span("step.forward"):
                loss, logs = loss_fn(images, labels, dynamic_weight, generator)
            with profiling.span("step.backward"):
                loss.backward()
            loss = loss.detach()
            logs = {name: v.detach() for name, v in logs.items()}
            if mesh is not None:
                with profiling.span("step.allreduce"):
                    # one bucket: every gradient, then the loss and the logs
                    values = [loss.float()] + [v.float() for v in logs.values()]
                    parallel.all_reduce_mean(mesh, [p.grad for p in _with_grads(model)] + values)
                loss, logs = values[0], dict(zip(logs, values[1:]))
            with profiling.span("step.update"):
                apply_gradients(state)
            return loss, logs

    step.loss_fn = loss_fn
    return step


def make_eval_forward(model: nn.Module,
                      fg_only: Optional[bool] = None) -> Callable:
    """``forward(window_batch)`` -> ``model``'s eval output, run in eval mode
    under ``torch.inference_mode()``: the one-hot argmax branch of a
    ``MaskTransUnet``, what another model's eval forward returns (as JAX's
    ``model.apply(x, train=False)``). Each call puts the model back in eval
    mode, so a training loop can evaluate between its steps (each train
    step puts it in train mode).

    ``fg_only`` (None = auto: on for a 2-class ``MaskTransUnet``) emits only
    the class-1 channel; pair it with
    ``SlidingWindowRunner(derive_background=forward.fg_only)``, which
    rebuilds class 0 as 1 - class 1 after the blend (exact for any blend
    weights).
    """
    from lintransunet_tpu_torch.models.registry import MaskTransUnet

    flagship = isinstance(model, MaskTransUnet)
    if fg_only is None:
        fg_only = flagship and model.dim_output == 2
    kwargs = {"return_aux": False, "fg_only": True} if fg_only else (
        {"return_aux": False} if flagship else {})
    model.eval()

    def forward(x: torch.Tensor) -> torch.Tensor:
        if model.training:
            model.eval()
        with torch.inference_mode():
            return model(x, **kwargs)

    forward.fg_only = fg_only
    return forward
