"""The least time the H100 could take for the port's programs: the eval
window, the fused eval window, the 5-window volume and the training step
(the counterpart of ``experiments/roofline.py``, with
``experiments/sw_batch_flops.py``'s question, is a batch of 2 linear in
FLOPs and bytes, as ``--batch``).

It counts the function, not the implementation. Every count runs the
program's plain path (``attention_impl="plain"``; in the fused
configuration the conv unit's and the stack's plain versions, which a CPU
tensor takes) on fake tensors (``FakeTensorMode(allow_non_fake_inputs=True)``)
over a model with real weights built outside the fake mode: nothing is
computed and no card is needed. The hand-written kernels are invisible to
``FlopCounterMode``, and the plain function is the same for every build, so
the default and the fused configuration count the same work. A program
built for counting is thrown away: its optimizer steps fake gradients into
its weights.

Three figures a program (``Cost``):

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s total, that is
  the convolutions, their backward, and mm, addmm and bmm, with one
  correction: the library counts a grouped convolution's weight gradient
  as a dense one's, and here it is divided by the groups (the step's 16
  depthwise PEG convolutions);
* ``bytes_fused``: the floor's byte term. Each convolution and product
  reads its operands once and writes its output once, a weight counted as
  the f32 parameter the model reads and casts; elementwise work is taken
  as fused into its producer. Add the program's input and output (for the
  step, AdamW's read of the parameters, gradients and both moments and its
  write of the parameters and moments, in f32);
* ``bytes_eager``: the inputs and outputs of every ATen op that is not a
  view, what the unfused eager program moves. Reported, not a floor.

``floor_ms = max(flops / PEAK_FLOPS[dtype], bytes_fused / HBM_BYTES_PER_S)``,
at the bf16 peak for the flagship's bf16 programs. ``per_module`` splits a
count by module (inclusive: a module's figure holds its submodules'), as
``FlopCounterMode`` attributes FLOPs; ``stage_flops`` turns it into stages.

    python -m lintransunet_tpu_torch.experiments.roofline [--batch 1 2] [--time]

prints the counts on the CPU without a card. ``--time`` times each program
warm on the card (10 runs back to back, one synchronise, CUDA events; the
median and the spread, the achieved TFLOP/s and the share of the floor,
with the card's name and power limit), with the kernels (``attention_impl=
"kernel"``) as a user runs it; without a card it raises. The fused
window's share is of the default window's floor, the same function
(``function_cost``).
"""

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop, flop_registry
from torch.utils.module_tracker import ModuleTracker
from torch.utils.weak import WeakIdKeyDictionary

from lintransunet_tpu_torch.experiments.common import HBM_BYTES_PER_S, PEAK_FLOPS, card

# bench.py's geometry for the flagship (``models.FLAGSHIP``): 512 x 512 x 64
# eval windows, a 512 x 512 x 144 volume (5 windows at overlap 0.6, constant
# blending), and the training step on a 512 x 512 x 32 patch with labels in
# the box of bench.py:189-190, the 5-level criterion schedule with the
# epoch-0 weights (bench.py:199-203) and AdamW at lr 1e-4.
WINDOW = (512, 512, 64)
VOLUME_DEPTH = 144
OVERLAP = 0.6
PATCH = (512, 512, 32)
LABEL_BOX = (slice(200, 320), slice(220, 300), slice(8, 24))
CRITERIA = ("CrossEntroLoss", "DiceClassLoss")
DYNAMIC = dict(epochs=1, T=12.0, warmup_step=10, weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
               initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0), final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))
LEARNING_RATE = 1e-4
DROPOUT = 0.3
SEED = 0
PROGRAMS = ("window", "fused", "volume", "step")
RUNS = 10
# AdamW's traffic a step, in f32 words a parameter: read p, g, m, v; write p, m, v
ADAMW_WORDS = 7


@dataclasses.dataclass(frozen=True)
class Cost:
    """What a program must do: ``flops``, ``bytes_fused`` (the floor's byte
    term), ``bytes_eager`` (what the eager program moves), and the same per
    module (inclusive; empty below the top)."""

    flops: int
    bytes_fused: int
    bytes_eager: int
    per_module: Mapping[str, "Cost"] = dataclasses.field(default_factory=dict)

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes_fused + other.bytes_fused,
                    self.bytes_eager + other.bytes_eager)

    def __sub__(self, other: "Cost") -> "Cost":
        return Cost(self.flops - other.flops, self.bytes_fused - other.bytes_fused,
                    self.bytes_eager - other.bytes_eager)

    def floor_ms(self, dtype: torch.dtype = torch.bfloat16) -> float:
        return max(self.flops / PEAK_FLOPS[dtype], self.bytes_fused / HBM_BYTES_PER_S) * 1e3

    def bound_by(self, dtype: torch.dtype = torch.bfloat16) -> str:
        ops = self.flops / PEAK_FLOPS[dtype]
        return "operations" if ops >= self.bytes_fused / HBM_BYTES_PER_S else "bytes"


ZERO = Cost(0, 0, 0)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _Traffic(TorchDispatchMode):
    """Bytes of every op, by module: ``fused`` the products' operands and
    outputs (a parameter, and what a view or cast of it alone gives, at the
    parameter's bytes), ``eager`` every non-view op's inputs and outputs."""

    def __init__(self, tracker: ModuleTracker):
        super().__init__()
        self.tracker = tracker
        self.fused: Dict[str, int] = {}
        self.eager: Dict[str, int] = {}
        self._param_bytes = WeakIdKeyDictionary()

    def _operand_bytes(self, t: torch.Tensor) -> int:
        if isinstance(t, torch.nn.Parameter):
            return t.numel() * t.element_size()
        return self._param_bytes.get(t, t.numel() * t.element_size())

    def _add(self, counts: Dict[str, int], nbytes: int) -> None:
        for name in set(self.tracker.parents):
            counts[name] = counts.get(name, 0) + nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket not in flop_registry and func is not torch.ops.prim.device.default:
            # a composite op (conv3d under inference_mode) counts as the ops
            # it decomposes into, as FlopCounterMode counts it
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        inputs = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outputs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.overloadpacket in flop_registry:
            self._add(self.fused, sum(self._operand_bytes(t) for t in inputs) + _nbytes(outputs))
        else:
            sources = {id(t): t for t in inputs}
            if len(sources) == 1:
                (source,) = sources.values()
                if isinstance(source, torch.nn.Parameter) or source in self._param_bytes:
                    for t in outputs:
                        self._param_bytes[t] = self._operand_bytes(source)
        if not func.is_view and func is not torch.ops.prim.device.default:
            self._add(self.eager, _nbytes(inputs) + _nbytes(outputs))
        return out


def _conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                        transposed, output_padding, groups, output_mask, out_shape, **kwargs):
    """``FlopCounterMode``'s convolution backward with the weight gradient
    of a grouped convolution divided by its groups: the library counts it
    as a dense convolution's (a depthwise 3x3x3 PEG's as C times its
    FLOPs), while its input gradient and the forward count groups right."""
    args = (grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation, transposed,
            output_padding, groups)
    formula = conv_backward_flop.__wrapped__  # on shapes, as custom_mapping calls this
    data = formula(*args, [output_mask[0], False, False], out_shape)
    weight = formula(*args, [False, output_mask[1], False], out_shape)
    return data + weight // groups


def program_cost(fn: Callable, *args) -> Cost:
    """The ``Cost`` of ``fn(*args)``, run once under the counters: on fake
    tensors (inside a ``FakeTensorMode``) for the plain function's count
    without computing it, or on real ones."""
    tracker = ModuleTracker()
    counter = FlopCounterMode(
        display=False, custom_mapping={torch.ops.aten.convolution_backward: _conv_backward_flop})
    with counter, tracker, _Traffic(tracker) as traffic:
        out = fn(*args)
    io = _nbytes(args) + _nbytes(out)
    flops = {name: sum(ops.values()) for name, ops in counter.get_flop_counts().items()}
    names = (set(flops) | set(traffic.fused) | set(traffic.eager)) - {"Global"}
    per_module = {name: Cost(flops.get(name, 0), traffic.fused.get(name, 0),
                             traffic.eager.get(name, 0)) for name in names}
    return Cost(counter.get_total_flops(), traffic.fused.get("Global", 0) + io,
                traffic.eager.get("Global", 0), per_module)


def build_model(program: str, device="cpu", attention_impl: str = "plain",
                dtype: torch.dtype = torch.bfloat16, seed: int = SEED, **config):
    """The flagship (``config`` overrides ``models.FLAGSHIP``) for ``program``:
    the fused eval configuration for "fused", training mode with dropout
    for "step", random weights from ``seed``."""
    from lintransunet_tpu_torch.models import flagship

    fused = program == "fused"
    model = flagship(seed, **config, dtype=dtype, dropout=DROPOUT, device=device,
                     attention_impl=attention_impl, fused_s1=fused, fused_stack=fused)
    return model.train() if program == "step" else model.eval()


def build_program(program: str, model, batch: int = 1, window=WINDOW,
                  volume_depth: int = VOLUME_DEPTH, patch=PATCH,
                  generator: Optional[torch.Generator] = None) -> Tuple[Callable, tuple]:
    """(fn, args) of ``program`` as a user runs it on ``model``'s device:
    ``make_eval_forward`` on ``batch`` windows ("window", "fused"), the
    ``make_eval_runner`` runner on one volume in groups of ``batch``
    windows ("volume"), or ``make_train_step`` on ``batch`` patches
    ("step"; AdamW's state and the dropout generator inside ``fn``).
    Inputs are N(0, 1) from ``generator`` (None: the global one, as fake
    tensors take)."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import (EvalConfig, get_criterion_list,
                                                   make_eval_runner)

    device = next(model.parameters()).device
    if program in ("window", "fused"):
        return (engine.make_eval_forward(model),
                (torch.randn((batch, 1) + tuple(window), generator=generator, device=device),))
    if program == "volume":
        cfg = EvalConfig(roi_size=window[0], depth_size=window[2], overlap=OVERLAP,
                         mode="constant")
        _, runner = make_eval_runner(model, cfg, sw_batch_size=batch)
        shape = (1, 1) + tuple(window[:2]) + (volume_depth,)
        return runner, (torch.randn(shape, generator=generator, device=device),)
    if program != "step":
        raise ValueError(f"program must be one of {PROGRAMS}, not {program!r}")
    criterions, _ = get_criterion_list(len(model.encode.num_layers), CRITERIA)
    state = engine.create_train_state(model, LEARNING_RATE)
    step = engine.make_train_step(model, criterions)
    dynamic_weight = engine.get_dynamic_weight(**DYNAMIC)[0]
    dropout = None if generator is None else torch.Generator(device=device).manual_seed(
        SEED + 6)
    images = torch.randn((batch, 1) + tuple(patch), generator=generator, device=device)
    labels = torch.zeros((batch,) + tuple(patch), dtype=torch.long, device=device)
    labels[(slice(None),) + LABEL_BOX] = 1

    def train_step(images, labels):
        return step(state, images, labels, dynamic_weight, dropout)

    return train_step, (images, labels)


def count(program: str, batch: int = 1, dtype: torch.dtype = torch.bfloat16,
          config: Optional[dict] = None, **geometry) -> Cost:
    """``program``'s ``Cost`` at ``batch``, counted on fake tensors over a
    fresh plain model (``config`` overrides ``models.FLAGSHIP``; ``geometry``
    passes ``window``, ``volume_depth`` or ``patch`` to ``build_program``)."""
    model = build_model(program, dtype=dtype, **(config or {}))
    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args = build_program(program, model, batch, **geometry)
        cost = program_cost(fn, *args)
    if program == "step":
        params = sum(p.numel() for p in model.parameters())
        cost = dataclasses.replace(cost, bytes_fused=cost.bytes_fused + ADAMW_WORDS * 4 * params)
    return cost


def require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device: it times the card, never the CPU")


def time_program(fn: Callable, args: Sequence, runs: int = RUNS) -> list:
    """ms of each of ``runs`` warm runs of ``fn(*args)`` back to back on the
    card: CUDA events between the runs, one synchronise at the end."""
    require_card()
    fn(*args)
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    events[0].record()
    for event in events[1:]:
        fn(*args)
        event.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def count_line(label: str, cost: Cost, dtype: torch.dtype = torch.bfloat16) -> str:
    return (f"{label}: flops {cost.flops} ({cost.flops / 1e9:.2f} GF), bytes_fused "
            f"{cost.bytes_fused} ({cost.bytes_fused / 1e9:.3f} GB), bytes_eager "
            f"{cost.bytes_eager} ({cost.bytes_eager / 1e9:.3f} GB), floor_ms "
            f"{cost.floor_ms(dtype):.4f} ({cost.bound_by(dtype)})")


def timing_line(label: str, cost: Cost, times: Sequence[float], card_name: str,
                dtype: torch.dtype = torch.bfloat16) -> str:
    """Median and spread of ``times``, the achieved TFLOP/s and the share
    of the floor, with the card."""
    median = statistics.median(times)
    floor = cost.floor_ms(dtype)
    return (f"{label}: {median:.3f} ms median of {len(times)} (spread {min(times):.3f}-"
            f"{max(times):.3f}), {cost.flops / median / 1e9:.2f} TFLOP/s, floor {floor:.4f} ms "
            f"({cost.bound_by(dtype)}), {floor / median * 100:.2f}% of it; card {card_name}")


def timed(program: str, batch: int = 1, runs: int = RUNS) -> list:
    """``program``'s warm times on the card with the kernels, as a user runs
    it (random weights and inputs from the seed)."""
    require_card()
    model = build_model(program, device="cuda", attention_impl="kernel")
    fn, args = build_program(program, model, batch,
                             generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    times = time_program(fn, args, runs)
    del model, fn, args
    torch.cuda.empty_cache()
    return times


def main(argv: Optional[Sequence[str]] = None) -> Dict[Tuple[str, int], Cost]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--time", action="store_true",
                        help="also time each program on the card (needs one)")
    args = parser.parse_args(argv)
    if args.time:
        require_card()
    card_name = card() if args.time else None
    costs = {}
    for program in PROGRAMS:
        for batch in args.batch:
            t0 = time.perf_counter()
            cost = costs[program, batch] = count(program, batch)
            line = count_line(f"{program} batch {batch}", cost)
            first = costs.get((program, args.batch[0]))
            if batch != args.batch[0]:
                line += "; against batch {}: flops x{:.4f}, bytes_fused x{:.4f}, bytes_eager x{:.4f}".format(
                    args.batch[0], cost.flops / first.flops, cost.bytes_fused / first.bytes_fused,
                    cost.bytes_eager / first.bytes_eager)
            print(f"{line}; counted in {time.perf_counter() - t0:.1f} s on the host", flush=True)
            if args.time:
                function = function_cost(program, batch, costs)
                print(timing_line(f"  {program} batch {batch} on the card", function,
                                  timed(program, batch), card_name), flush=True)
    return costs


def function_cost(program: str, batch: int, costs: Dict[Tuple[str, int], Cost]) -> Cost:
    """The count that ``program``'s floor rests on: its own, but for the
    fused window the default window's, the same function (the fused
    configuration's plain versions compute it in another formulation, the
    stack's tokens in f32, which moves ``bytes_fused``; their FLOPs are
    equal)."""
    source = "window" if program == "fused" else program
    if (source, batch) not in costs:
        costs[source, batch] = count(source, batch)
    return costs[source, batch]


if __name__ == "__main__":
    main()
