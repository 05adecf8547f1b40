"""Which convolution calls of the benchmark's models reach which kernels on
one CUDA card.

    python3 tools/attribute_convs.py [--out attribution.json]

Builds the benchmark's three configurations (``portbench/configs``: the
flagship, its fused eval build and the bottle model) in bf16 with weights
drawn from one seed, and records under ``torch.profiler`` with
``record_shapes``, each warm:

* ``serve``: one forward of 4 windows of 512 x 512 x 32 under
  ``torch.inference_mode()`` (the serve cells' batch);
* ``train`` (the flagship): one eager forward and backward of 3 patches of
  512 x 512 x 32 in train mode, the loss a random weighting of the output
  and of every mask of the deep supervision (the train cells' batch).

Each device kernel is linked to the ATen op that launched it (the
profiler's correlation id); a convolution's forward is named by the
``Conv3d`` module it ran in (forward hooks open a ``conv:<module>`` range),
its backward (``aten::convolution_backward``) by the module whose input and
weight shapes it shows. It prints, per convolution call and phase, each
kernel's device ms a forward or a step, and flags cuDNN's generic engine
(``implicit_convolveNd_sgemm``); then the engine's total time beside the
share of it the table accounts for. The JSON holds the same rows.
"""

import argparse
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lintransunet_tpu_torch.models.blocks import Conv3d  # noqa: E402
from portbench import program  # noqa: E402

CONFIGS = ("masktransunet-pancreas", "masktransunet-pancreas-fused", "bottletransunet")
SEED = 3141592653
WINDOW = (512, 512, 32)
SERVE_BATCH, TRAIN_BATCH = 4, 3
GENERIC = "implicit_convolveNd_sgemm"
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
            "aten::cudnn_convolution_transpose", "aten::_convolution")


def load_config(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


class Names:
    """Forward hooks on every ``Conv3d``: a ``conv:<module>`` profiler range
    around its forward, and the (input shape, weight shape) each module saw."""

    def __init__(self, model):
        self.by_shapes = {}
        self.handles = []
        for name, mod in model.named_modules():
            if isinstance(mod, Conv3d):
                self.handles.append(mod.register_forward_pre_hook(self._enter(name)))
                self.handles.append(mod.register_forward_hook(self._exit))
        self.open = []

    def _enter(self, name):
        def hook(mod, args):
            self.by_shapes[(tuple(args[0].shape), tuple(mod.weight.shape))] = name
            rf = torch.profiler.record_function(f"conv:{name}")
            rf.__enter__()
            self.open.append(rf)
        return hook

    def _exit(self, mod, args, out):
        self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()


def ancestors(evt):
    while evt is not None:
        yield evt
        evt = evt.cpu_parent


def attribute(prof, names):
    """{(module, op, shapes): {kernel: [launches, device us]}} and the total
    device us of every kernel and of the generic engine."""
    rows = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    total = generic_total = 0.0
    for evt in prof.events():
        if evt.device_type != DeviceType.CPU or not evt.kernels:
            continue
        chain = list(ancestors(evt))
        op = next((e for e in chain if e.name in CONV_OPS), None)
        module = next((e.name[5:] for e in chain if e.name.startswith("conv:")), None)
        for k in evt.kernels:
            total += k.duration
            if GENERIC in k.name:
                generic_total += k.duration
            if op is None:
                if GENERIC in k.name:
                    rows[("?", evt.name, str(evt.input_shapes))][k.name][0] += 1
                    rows[("?", evt.name, str(evt.input_shapes))][k.name][1] += k.duration
                continue
            shapes = op.input_shapes
            if op.name == "aten::convolution_backward" and len(shapes) >= 3:
                module = names.by_shapes.get((tuple(shapes[1]), tuple(shapes[2])), "?")
            key = (module or "?", op.name, str(shapes[:3]))
            rows[key][k.name][0] += 1
            rows[key][k.name][1] += k.duration
    return rows, total, generic_total


def record(fn, names):
    fn()  # warm: cuDNN's choice of algorithm, the kernel builds
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA],
                                record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    return attribute(prof, names)


def report(label, rows, total, generic_total, out):
    print(f"\n== {label}: device {total / 1e3:.3f} ms, of it {GENERIC} "
          f"{generic_total / 1e3:.3f} ms", flush=True)
    seen = 0.0
    for (module, op, shapes), kernels in sorted(
            rows.items(), key=lambda kv: -sum(v[1] for v in kv[1].values())):
        conv_us = sum(v[1] for v in kernels.values())
        generic = sum(v[1] for k, v in kernels.items() if GENERIC in k)
        seen += generic
        entry = {"phase": label, "module": module, "op": op, "shapes": shapes,
                 "ms": conv_us / 1e3, "generic_ms": generic / 1e3,
                 "kernels": {k: [v[0], v[1] / 1e3] for k, v in kernels.items()}}
        out.append(entry)
        flag = "  <-- generic engine" if generic else ""
        print(f"{label} | {module} | {op} | {shapes} | {conv_us / 1e3:.4f} ms | generic "
              f"{generic / 1e3:.4f} ms{flag}", flush=True)
        for k, (n, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1]):
            print(f"    {n} x {k[:110]}: {us / 1e3:.4f} ms", flush=True)
    share = seen / generic_total * 100 if generic_total else 100.0
    print(f"{label}: the rows hold {seen / 1e3:.4f} ms of the generic engine's "
          f"{generic_total / 1e3:.4f} ms ({share:.1f}%)", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="attribution.json",
                        help="where the rows go as JSON (default: the current directory)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs only on an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for config_name in CONFIGS:
        config = load_config(config_name)
        state = program.weights(config, SEED, "cuda")
        model = program.build_model(config, state, "cuda").eval()
        names = Names(model)
        window = torch.randn((SERVE_BATCH, 1) + WINDOW, device="cuda", generator=gen)

        def serve():
            with torch.inference_mode():
                model(window)

        report(f"{config_name} serve (a forward of {SERVE_BATCH} windows)",
               *record(serve, names), out)
        if config_name == "masktransunet-pancreas":
            model.train()
            patch = torch.randn((TRAIN_BATCH, 1) + WINDOW, device="cuda", generator=gen)

            def step():
                model.zero_grad(set_to_none=True)
                prob, masks = model(patch, return_aux=True)
                loss = (prob.float() * torch.rand_like(prob.float())).sum()
                for m in masks:
                    loss = loss + (m.float() * torch.rand_like(m.float())).sum()
                loss.backward()

            report(f"{config_name} train (forward and backward of {TRAIN_BATCH} patches)",
                   *record(step, names), out)
        names.remove()
        del model, state
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(f"\nwrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
