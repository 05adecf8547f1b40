"""Per-stage floors of the eval window on the H100 (the counterpart of
``experiments/stage_flops.py``, with ``experiments/profile_stages.py``'s
question, each stage's time, answered on the card by ``--time``).

The window's ``roofline.Cost`` (the plain function on fake tensors, see
``roofline``) split by module into stages: each direct child of the
encoder (the input block, each ``DownBlock``) and of the decoder (the
``ConnectBridge``, each level's mask conv, attention gate, ``ROIBridge``
and ``UpBlock``, the final block); then what the encoder, the decoder and
the model run outside those children (the decoder's upsamples, softmaxes
and concats; the model's input cast, the embedding and the epilogue); then
the program's input and output. The stages' figures sum to the window's.

    python -m lintransunet_tpu_torch.experiments.stage_flops [--time]

prints each stage's FLOPs, bytes and floor on the CPU without a card.
``--time`` also runs the window with the kernels on the card, 10 runs back
to back, CUDA events recorded by forward hooks at each stage's entry and
exit, and prints each stage's median time, its spread and its share of its
floor, with the card's name and power limit; without a card it raises. The
program's own row times what runs outside the model (its time less the
model's), which its bytes do not bound, so it has no share.
"""

import argparse
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from lintransunet_tpu_torch.experiments import roofline
from lintransunet_tpu_torch.experiments.common import card

ROOT = "MaskTransUnet"
PARENTS = ("encode", "decode")
MODEL_OWN = "model, outside encode and decode"
PROGRAM_IO = "program input and output"


def stage_modules(model) -> Dict[str, torch.nn.Module]:
    """{stage label: module}: each direct child of the encoder and the
    decoder, then the encoder, the decoder and the model themselves (whose
    own ops are what their children leave)."""
    out = {f"{parent}.{name}": child for parent in PARENTS
           for name, child in getattr(model, parent).named_children()}
    out.update({parent: getattr(model, parent) for parent in PARENTS})
    out[ROOT] = model
    return out


def split(values: Dict[str, float], model, total: float) -> List[Tuple[str, float]]:
    """Stage rows that sum to ``total`` from inclusive per-module
    ``values`` keyed as ``stage_modules``: the children, each parent's own
    part, the model's own part and the program's remainder. Works for
    ``Cost``s and for times alike."""
    zero = total - total
    rows = []
    for parent in PARENTS:
        children = [(f"{parent}.{name}", values.get(f"{parent}.{name}", zero))
                    for name, _ in getattr(model, parent).named_children()]
        rows += children
        own = values.get(parent, zero)
        for _, value in children:
            own = own - value
        rows.append((f"{parent}, outside its children", own))
    own = values.get(ROOT, zero)
    for parent in PARENTS:
        own = own - values.get(parent, zero)
    rows.append((MODEL_OWN, own))
    rows.append((PROGRAM_IO, total - values.get(ROOT, zero)))
    return rows


def stage_costs(cost: roofline.Cost, model) -> List[Tuple[str, roofline.Cost]]:
    """The window's ``cost`` as stage rows (``split`` of its per-module
    figures, whose names ``ModuleTracker`` roots at the model's class)."""
    values = {label: cost.per_module.get(label if label == ROOT else f"{ROOT}.{label}",
                                         roofline.ZERO)
              for label in stage_modules(model)}
    return split(values, model, cost)


class StageTimer:
    """CUDA events at each stage module's entry and exit (forward pre-hooks
    and hooks), for every run of the window while it is on."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.runs: List[Dict[str, Tuple[torch.cuda.Event, torch.cuda.Event]]] = []
        self._handles = []
        for label, module in modules.items():
            self._handles.append(module.register_forward_pre_hook(self._enter(label)))
            self._handles.append(module.register_forward_hook(self._exit(label)))

    def _enter(self, label):
        def hook(module, args):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.runs[-1][label] = (event, None)
        return hook

    def _exit(self, label):
        def hook(module, args, out):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.runs[-1][label] = (self.runs[-1][label][0], event)
        return hook

    def new_run(self) -> None:
        self.runs.append({})

    def times(self) -> List[Dict[str, float]]:
        """Per run, {stage label: ms}; call after a synchronise."""
        return [{label: start.elapsed_time(end) for label, (start, end) in run.items()}
                for run in self.runs]

    def close(self) -> None:
        for handle in self._handles:
            handle.remove()


def time_stages(runs: int = roofline.RUNS) -> List[Dict[str, float]]:
    """Per run, {stage label: ms}, with ``PROGRAM_IO``'s key holding the
    whole program's time: the window with the kernels on the card, warm,
    ``runs`` runs back to back and one synchronise."""
    roofline.require_card()
    model = roofline.build_model("window", device="cuda", attention_impl="kernel")
    fn, args = roofline.build_program(
        "window", model, generator=torch.Generator(device="cuda").manual_seed(roofline.SEED + 1))
    fn(*args)
    torch.cuda.synchronize()
    timer = StageTimer(stage_modules(model))
    whole = []
    try:
        for _ in range(runs):
            timer.new_run()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            whole.append((start, end))
        torch.cuda.synchronize()
    finally:
        timer.close()
    out = timer.times()
    for run, (start, end) in zip(out, whole):
        run[PROGRAM_IO] = start.elapsed_time(end)
    del model, fn, args
    torch.cuda.empty_cache()
    return out


def main(argv: Optional[Sequence[str]] = None) -> List[Tuple[str, roofline.Cost]]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--time", action="store_true",
                        help="also time each stage on the card (needs one)")
    args = parser.parse_args(argv)
    if args.time:
        roofline.require_card()
    cost = roofline.count("window")
    model = roofline.build_model("window")  # its module tree names the stages
    rows = stage_costs(cost, model)
    timed = None
    if args.time:
        per_run = time_stages()
        timed = [split(run, model, run[PROGRAM_IO]) for run in per_run]
        print(f"card {card()}; {len(per_run)} warm windows back to back", flush=True)
    print(f"{'stage':<44s} {'GF':>9s} {'fused GB':>9s} {'eager GB':>9s} {'floor ms':>9s} by",
          flush=True)
    for i, (label, stage) in enumerate(rows):
        line = (f"{label:<44s} {stage.flops / 1e9:9.2f} {stage.bytes_fused / 1e9:9.3f} "
                f"{stage.bytes_eager / 1e9:9.3f} {stage.floor_ms():9.4f} {stage.bound_by():10s}")
        if timed is not None:
            ms = [run[i][1] for run in timed]
            median = statistics.median(ms)
            line += f" {median:8.3f} ms (spread {min(ms):.3f}-{max(ms):.3f})"
            # the program's own row times what runs outside the model, not its bytes
            if label != PROGRAM_IO and stage.floor_ms() > 0 and median > 0:
                line += f", {stage.floor_ms() / median * 100:6.2f}% of its floor"
        print(line, flush=True)
    print(roofline.count_line("window, the stages' sum", cost), flush=True)
    return rows


if __name__ == "__main__":
    main()
