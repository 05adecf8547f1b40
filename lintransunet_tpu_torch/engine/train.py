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

On the card every micro-step is the replay of a CUDA graph that holds the
whole micro-step: the forward and the loss, the backward, the all-reduce
under a mesh, the accumulation and, on the k-th micro-step, the hand-over to
``.grad`` and AdamW (``make_optimizer`` makes it ``capturable``). A group on
another backend than NCCL (gloo, whose collectives on CUDA tensors wait on
the host) cannot be captured: there the micro-step is two graphs, the
forward and backward, then the update, with the all-reduce launched eagerly
between their replays, and a criterion that reduces over the group inside
the loss (``losses.multiclass.ClassifyLoss``) is refused when the step is
built. The step captures once per signature (the inputs'
shapes and dtypes, the generator, the optimizer, the mesh) and phase (the
micro-step's place in the ``step_times`` cycle), all in one memory pool,
after one eager forward and backward (and all-reduce under a mesh) on the
signature's own stream that leaves the parameters, the optimizer, the
counters and the generator as it found them. Every call copies its inputs
into the graph's buffers and returns clones of the loss and the logs. The
dropout generator is registered with each graph, so a replay draws the
masks the eager step would. On the CPU the step runs eagerly. A capture
that fails raises.

A step runs in the profiler span ``step`` (``utils.profiling.span``; its
``seq`` the state's micro-step count). An eager micro-step has
``step.forward`` (the model and the loss), ``step.backward``,
``step.allreduce`` (under a mesh) and ``step.update`` inside;
``apply_gradients`` splits the update into ``update.accumulate`` and
``update.optimizer``. A replayed one has ``step.replay`` around the graphs'
launches (and the eager all-reduce between two). ``profiling.counts`` counts
``step.replayed`` and ``step.eager`` micro-steps, ``step.captured``
micro-steps captured and ``step.warmed_up`` signatures warmed up: the
forward and backward run in Python once for each of the last three, and a
replay repeats a captured one's launches.
"""

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
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
    decoupled weight decay on every parameter. For parameters on the card it
    is ``capturable`` and its learning rate a device tensor, which
    ``set_learning_rate`` writes in place, so that a captured update reads
    the current rate."""
    params = list(params)
    if params and params[0].is_cuda:
        lr = torch.tensor(learning_rate, dtype=torch.float32, device=params[0].device)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, capturable=True)
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
    """Write a new LR into every parameter group (the plateau scheduler's
    hook), into its device tensor where it has one."""
    for group in state.optimizer.param_groups:
        if torch.is_tensor(group["lr"]):
            group["lr"].fill_(lr)
        else:
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


def _advance(state: TrainState) -> None:
    """The counters of one micro-step."""
    state.step += 1
    state.mini_step = (state.mini_step + 1) % state.step_times
    if state.mini_step == 0:
        state.gradient_step += 1


def apply_gradients(state: TrainState) -> None:
    """One micro-step on the gradients in each parameter's ``.grad``:
    ``optax.MultiSteps(adamw, every_k_schedule=step_times)``'s update."""
    params = _with_grads(state.model)
    update = state.mini_step == state.step_times - 1  # the micro-step ends a cycle
    if state.step_times > 1:
        with profiling.span("update.accumulate"), torch.no_grad():
            _make_accumulators(state, params)
            n = state.mini_step
            for acc, p in zip(state.acc_grads, params):
                acc.add_((p.grad.float() - acc) / (n + 1))
            if update:
                for acc, p in zip(state.acc_grads, params):  # the mean goes to the optimizer
                    p.grad.copy_(acc)
                    acc.zero_()
    if update:
        with profiling.span("update.optimizer"):
            state.optimizer.step()
    _advance(state)


def _make_accumulators(state: TrainState, params: List[nn.Parameter]) -> None:
    """The running means of ``step_times`` > 1, zero, where missing."""
    if state.step_times > 1 and state.acc_grads is None:
        state.acc_grads = [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _init_moments(optimizer: torch.optim.Optimizer) -> None:
    """AdamW's state of every parameter, as its first step would make it,
    where it is missing: a captured update must find it, since one made in a
    capture would be zeroed again on every replay."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def python_passes() -> int:
    """How many times train steps have run the forward and backward through
    Python: eager micro-steps, warm-ups and captures (``profiling.counts``).
    A replay launches what its capture launched without Python, so a
    kernel wrapper's count of its calls counts these passes alone."""
    return sum(profiling.counts[k] for k in ("step.eager", "step.warmed_up", "step.captured"))


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
    alone, (loss, logs), for a caller that differentiates it itself;
    ``step.graphs`` holds the step's CUDA graphs (``captured``: one
    micro-step, of one graph or two, a signature and phase).

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
        if (mesh.device.type == "cuda" and dist.get_backend() != "nccl"
                and any(hasattr(fn, "over_group") for level in criterions for fn in level.values())):
            raise ValueError("a criterion that reduces over the group inside the loss cannot be "
                             "captured in a CUDA graph over gloo, which waits on the host: "
                             "run the ranks over NCCL")
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

    def gradients(images, labels, dynamic_weight, generator):
        """The forward, the loss and the backward: (loss, logs), detached."""
        with profiling.span("step.forward"):
            loss, logs = loss_fn(images, labels, dynamic_weight, generator)
        with profiling.span("step.backward"):
            loss.backward()
        return loss.detach(), {name: v.detach() for name, v in logs.items()}

    def all_reduce(loss, logs):
        """Under a mesh, the gradients, the loss and the logs averaged over
        the group in one bucket."""
        if mesh is None:
            return loss, logs
        with profiling.span("step.allreduce"):
            values = [loss.float()] + [v.float() for v in logs.values()]
            parallel.all_reduce_mean(mesh, [p.grad for p in _with_grads(model)] + values)
        return values[0], dict(zip(logs, values[1:]))

    def update(state: TrainState):
        with profiling.span("step.update"):
            apply_gradients(state)

    def micro_step(state: TrainState, images, labels, dynamic_weight, generator):
        """The micro-step as it runs eagerly and as one graph captures it."""
        loss, logs = all_reduce(*gradients(images, labels, dynamic_weight, generator))
        update(state)
        return loss, logs

    graphs = _Graphs(model, loss_fn, gradients, all_reduce, update, micro_step, mesh)

    def step(state: TrainState, images, labels, dynamic_weight, generator=None):
        if state.model is not model:
            raise ValueError("the train state holds another model than this step's")
        with profiling.span("step", state.step):
            model.train()
            if images.is_cuda:
                return graphs.replay(state, images, labels, dynamic_weight, generator)
            profiling.counts["step.eager"] += 1
            state.optimizer.zero_grad(set_to_none=True)
            return micro_step(state, images, labels, dynamic_weight, generator)

    step.loss_fn = loss_fn
    step.graphs = graphs
    return step


@dataclasses.dataclass
class _Captured:
    """One captured micro-step: its graphs (the whole micro-step, or the
    forward and backward then the update, around an eager all-reduce), the
    static buffers it reads its inputs from and writes its loss and logs
    to, and the gradient tensors its backward writes (each parameter's
    ``.grad`` after a replay)."""

    graphs: List["torch.cuda.CUDAGraph"]
    inputs: tuple
    loss: torch.Tensor
    logs: Dict[str, torch.Tensor]
    params: List[nn.Parameter]
    grads: List[torch.Tensor]


class _Graphs:
    """The CUDA graphs of one train step, one micro-step per signature and
    phase, in one memory pool.

    Each signature has its own capture stream and static inputs, shared by
    its phases. Its own stream gives it its own linear-attention workspace
    (``ops.linear_attention`` keeps one per stream, zeroed tickets between
    calls): a later signature that grows a workspace cannot free one that a
    graph reads. The graphs share the pool because they never run at once:
    each replay finishes its temporaries before the next one starts."""

    def __init__(self, model, loss_fn, gradients, all_reduce, update, micro_step, mesh):
        self.model, self.loss_fn, self.mesh = model, loss_fn, mesh
        self.gradients, self.all_reduce = gradients, all_reduce
        self.update, self.micro_step = update, micro_step
        self.captured = {}  # (signature, phase) -> _Captured
        self.streams = {}   # signature -> (stream, static inputs)
        self.pool = None

    def replay(self, state, images, labels, dynamic_weight, generator):
        weights = torch.as_tensor(dynamic_weight, dtype=torch.float32)
        signature = (tuple(images.shape), images.dtype, tuple(labels.shape), labels.dtype,
                     tuple(weights.shape), generator, state.optimizer, self.mesh)
        phase = state.mini_step
        captured = self.captured.get((signature, phase))
        if captured is None:
            captured = self._capture(signature, phase, state, images, labels, weights, generator)
        for static, value in zip(captured.inputs, (images, labels, weights)):
            static.copy_(value)
        for p, grad in zip(captured.params, captured.grads):
            p.grad = grad
        loss, logs = captured.loss, captured.logs
        with profiling.span("step.replay"):
            captured.graphs[0].replay()
            if len(captured.graphs) == 2:
                loss, logs = self.all_reduce(loss, logs)
                captured.graphs[1].replay()
        _advance(state)
        profiling.counts["step.replayed"] += 1
        return loss.clone(), {name: v.clone() for name, v in logs.items()}

    def _capture(self, signature, phase, state, images, labels, weights, generator):
        if signature not in self.streams:
            inputs = tuple(torch.empty(v.shape, dtype=v.dtype, device=images.device)
                           for v in (images, labels, weights))
            for static, value in zip(inputs, (images, labels, weights)):
                static.copy_(value)
            stream = torch.cuda.Stream(images.device)
            self._warm_up(stream, inputs, generator)
            self.streams[signature] = (stream, inputs)
        stream, inputs = self.streams[signature]
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        params = [p for p in self.model.parameters() if p.requires_grad]
        _init_moments(state.optimizer)  # made here, not in the graph's pool
        _make_accumulators(state, params)
        counters = (state.step, state.mini_step, state.gradient_step)
        state.optimizer.zero_grad(set_to_none=True)
        stream.wait_stream(torch.cuda.current_stream(images.device))
        # NCCL's collectives can be captured, gloo's wait on the host
        if self.mesh is None or dist.get_backend() == "nccl":
            graph, (loss, logs) = self._graph(
                stream, generator, lambda: self.micro_step(state, *inputs, generator))
            graphs = [graph]
        else:
            first, (loss, logs) = self._graph(
                stream, generator, lambda: self.gradients(*inputs, generator))
            graphs = [first, self._graph(stream, None, lambda: self.update(state))[0]]
        torch.cuda.current_stream(images.device).wait_stream(stream)
        state.step, state.mini_step, state.gradient_step = counters
        captured = self.captured[(signature, phase)] = _Captured(
            graphs, inputs, loss, logs, params, [p.grad for p in params])
        profiling.counts["step.captured"] += 1
        return captured

    def _graph(self, stream, generator, fn):
        """(a graph of ``fn()`` captured on ``stream`` in the pool, what
        ``fn`` returned); dropout's ``generator`` registered with it."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # thread_local: the NCCL watchdog's thread may query events meanwhile
        with torch.cuda.graph(graph, pool=self.pool, stream=stream,
                              capture_error_mode="thread_local"):
            out = fn()
        return graph, out

    def _warm_up(self, stream, inputs, generator):
        """One forward and backward on the capture stream, and under a mesh
        the gradients' all-reduce, so that a capture finds its libraries'
        handles, algorithms, workspaces and communicator warmed; the
        generator is put back and the gradients dropped."""
        device = inputs[0].device
        start = (torch.cuda.get_rng_state(device) if generator is None
                 else generator.get_state())
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            loss, _ = self.loss_fn(*inputs, generator)
            loss.backward()
            if self.mesh is not None:
                parallel.all_reduce_mean(self.mesh, [p.grad for p in _with_grads(self.model)])
        torch.cuda.current_stream(device).wait_stream(stream)
        self.model.zero_grad(set_to_none=True)
        if generator is None:
            torch.cuda.set_rng_state(start, device)
        else:
            generator.set_state(start)
        profiling.counts["step.warmed_up"] += 1


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
