"""Training trajectories of the port: many steps of binary or multi-class
training on one seeded data stream, from a given state (the port's side of
the JAX package's ``experiments/parity_training.py`` and
``experiments/parity_training_multiclass.py``).

The recipe is those scripts' (the reference's deep supervision):

* the model: ``MaskTransUnet`` at ``SMALL`` (widths 8-64, ROI sizes
  16-4), dropout 0, f32 (TF32 off on the card), batch 1;
* the data (``make_data``, a copy of the JAX scripts' generator): 64 x 64
  x 16 patches of noise, binary (seed 1234) a bright blob labelled 1,
  multi-class (seed 4321) an outer shell labelled 1 around a core
  labelled 2;
* binary: the per-level criterion schedule (train3D.py:139-155, coarse to
  fine: CE + BalanceDice on three levels, CE + DiceClass on two) and the
  epoch-0 dynamic weights min(initial + weight, final) of
  train3D.py:91-99;
* multi-class: CE + DiceClass + DiceClass2 at every level, criterion
  weights (10, 1, 2), one-hot targets over 3 classes, and the multi-class
  dynamic-weight defaults (train3D_multi_class.py:142-148);
* the port's ``make_train_step`` with AdamW at the given learning rate.

``run`` returns the loss of each step, the first step whose loss is not
finite and, at that step, the first module and the first ATen op whose
output is not finite: that step's forward is run again from the
parameters it started from with ``utils.debug.nan_guard`` on every
module's output and on every op's, and the first line nan_guard prints of
each kind names them ("loss" if every output is finite). It also gives the
first step after whose update a parameter is not finite.

    python -m lintransunet_tpu_torch.experiments.parity_training [--kind binary]
        [--lr 3e-5] [--steps 40] [--device cuda]

runs the kernels' trajectory and the plain one (``attention_impl``
"kernel" and "plain") from one random initial state on the card, under
deterministic algorithms, and prints the largest relative loss difference.
``tools/parity_training.py`` holds the plain trajectory against the JAX
package's on the CPU.
"""

import argparse
import contextlib
import dataclasses
import io
import math
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.module_tracker import ModuleTracker

STEPS = 40
PATCH = (64, 64, 16)
SMALL = dict(num_layers=(8, 16, 32, 32, 64), roi_size_list=(16, 12, 8, 6, 4),
             is_roi_list=(False, True, True, True, True), dim_input=1)
SEED = 0


def _epoch0(weight_list, initial, final):
    """get_weight at epoch 0 (utils_3D_embed_full.py:16-19): min(initial +
    weight * e^0, final)."""
    return [min(i + w, f) for w, i, f in zip(weight_list, initial, final)]


@dataclasses.dataclass(frozen=True)
class Recipe:
    classes: int
    data_seed: int
    criteria: tuple             # per level, coarse to fine
    dynamic_weight: tuple
    criterion_weight: Optional[tuple] = None


KINDS = {
    "binary": Recipe(
        classes=2, data_seed=1234,
        criteria=(("CrossEntroLoss", "BalanceDiceLoss"),) * 3
        + (("CrossEntroLoss", "DiceClassLoss"),) * 2,
        dynamic_weight=tuple(_epoch0([0.05, 0.05, 0.1, 0.1, 1.0], [0.1, 0.2, 0.3, 0.4, 1.0],
                                     [2.0, 1.5, 1.0, 1.0, 1.0]))),
    "multiclass": Recipe(
        classes=3, data_seed=4321,
        criteria=(("CrossEntroLoss", "DiceClassLoss", "DiceClassLoss2"),) * 5,
        dynamic_weight=tuple(_epoch0([0.05, 0.05, 0.1, 0.1, 1.0], [0.2, 0.2, 0.3, 0.3, 0.4],
                                     [2.0, 1.5, 0.5, 0.5, 0.4])),
        criterion_weight=(10.0, 1.0, 2.0)),
}


@dataclasses.dataclass
class Trajectory:
    losses: List[float]
    first_nonfinite: Optional[int] = None
    module: Optional[str] = None
    op: Optional[str] = None
    first_nonfinite_update: Optional[int] = None


def make_data(kind: str, steps: int = STEPS):
    """(images (steps + 4, H, W, D) f32, labels (steps + 4, H, W, D) int64):
    the JAX scripts' seeded stream; its first items do not depend on
    ``steps``."""
    multi = kind == "multiclass"
    rng = np.random.default_rng(KINDS[kind].data_seed)
    h, w, d = PATCH
    yy, xx, zz = np.meshgrid(np.arange(h), np.arange(w), np.arange(d), indexing="ij")
    images, labels = [], []
    for _ in range(steps + 4):
        cy, cx, cz = rng.uniform(16, 48), rng.uniform(16, 48), rng.uniform(4, 12)
        r = rng.uniform(8, 14) if multi else rng.uniform(6, 14)
        dist = (yy - cy) ** 2 + (xx - cx) ** 2 + ((zz - cz) * 2.0) ** 2
        if multi:
            outer, core = dist < r * r, dist < (r * 0.5) ** 2
            label = outer.astype(np.int64) + core.astype(np.int64)
            image = rng.standard_normal((h, w, d)) * 0.3 + outer * 0.8 + core * 1.2
        else:
            blob = dist < r * r
            label = blob.astype(np.int64)
            image = rng.standard_normal((h, w, d)) * 0.3 + blob * 1.5
        images.append(image.astype(np.float32))
        labels.append(label)
    return np.stack(images), np.stack(labels)


def build_model(kind: str, device="cuda", attention_impl: str = "kernel",
                state_dict: Optional[Dict[str, torch.Tensor]] = None):
    """The f32 SMALL model of ``kind`` at dropout 0, in train mode, from
    ``state_dict`` or else random weights from ``SEED``."""
    from lintransunet_tpu_torch.models import MaskTransUnet, init_random_

    model = MaskTransUnet(**SMALL, dim_output=KINDS[kind].classes, dropout=0.0,
                          dtype=torch.float32, device=device, attention_impl=attention_impl)
    if state_dict is None:
        init_random_(model, torch.Generator(device="cpu").manual_seed(SEED))
    else:
        model.load_state_dict(state_dict, strict=True)
    return model.train()


class _OpGuard(TorchDispatchMode):
    """``nan_guard`` on every floating output of every ATen op, labelled
    with the op and the innermost module running it."""

    def __init__(self, tracker: ModuleTracker):
        super().__init__()
        self.tracker = tracker

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from lintransunet_tpu_torch.utils.debug import nan_guard

        out = func(*args, **(kwargs or {}))
        inner = max(self.tracker.parents, key=len).split(".", 1)[-1]
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                nan_guard(t, f"op {func.overloadpacket} in {inner}")
        return out


def first_nonfinite(model, images: torch.Tensor):
    """(module, op): the first module whose train-mode output on ``images``
    is not finite and the first ATen op whose output is not (with the
    innermost module running it), as ``nan_guard`` on each names them; the
    module is "loss" and the op None if every output is finite."""
    from lintransunet_tpu_torch.utils.debug import nan_guard

    def guard(name):
        def hook(module, args, out):
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and t.is_floating_point():
                    nan_guard(t, f"module {name}")
        return hook

    handles = [m.register_forward_hook(guard(name or "model"))
               for name, m in model.named_modules()]
    printed = io.StringIO()
    tracker = ModuleTracker()
    try:
        with torch.no_grad(), contextlib.redirect_stdout(printed), tracker, _OpGuard(tracker):
            model(images)
    finally:
        for handle in handles:
            handle.remove()
    found = [line.split("non-finite values in ", 1)[1] for line in printed.getvalue().splitlines()]
    module = next((x[len("module "):] for x in found if x.startswith("module ")), "loss")
    op = next((x[len("op "):] for x in found if x.startswith("op ")), None)
    return module, op


def run(kind: str, model, lr: float, steps: int = STEPS, data=None) -> Trajectory:
    """``steps`` train steps of ``model`` (``build_model``) on ``kind``'s
    stream at ``lr``."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.losses import binary, multiclass

    recipe = KINDS[kind]
    multi = kind == "multiclass"
    module = multiclass if multi else binary
    criterions = [module.get_criterions(list(names)) for names in recipe.criteria]
    step = engine.make_train_step(
        model, criterions, criterion_weight=list(recipe.criterion_weight) if multi else None,
        num_classes=recipe.classes if multi else None)
    state = engine.create_train_state(model, lr)
    images, labels = make_data(kind, steps) if data is None else data
    device = next(model.parameters()).device
    out = Trajectory(losses=[])
    for t in range(steps):
        x = torch.from_numpy(images[t][None, None]).to(device)
        y = torch.from_numpy(labels[t][None]).to(device)
        start = ({k: v.detach().clone() for k, v in model.state_dict().items()}
                 if out.first_nonfinite is None else None)
        loss, _ = step(state, x, y, list(recipe.dynamic_weight))
        out.losses.append(loss.item())
        if out.first_nonfinite is None and not math.isfinite(out.losses[-1]):
            out.first_nonfinite = t
            now = {k: v.detach().clone() for k, v in model.state_dict().items()}
            model.load_state_dict(start)
            out.module, out.op = first_nonfinite(model, x)
            model.load_state_dict(now)
        if out.first_nonfinite_update is None and not all(
                bool(torch.isfinite(p).all()) for p in model.parameters()):
            out.first_nonfinite_update = t
    return out


def max_rel_diff(a: List[float], b: List[float]) -> float:
    """The largest |a - b| / |a| over the steps where both are finite."""
    rel = [abs(x - y) / max(abs(x), 1e-8) for x, y in zip(a, b)
           if math.isfinite(x) and math.isfinite(y)]
    return max(rel) if rel else float("nan")


def kernel_vs_plain(kind: str, lr: float, steps: int = STEPS, device="cuda"):
    """The kernels' and the plain trajectory from one random state on
    ``device``: (kernel, plain)."""
    data = make_data(kind, steps)
    return tuple(run(kind, build_model(kind, device, impl), lr, steps, data)
                 for impl in ("kernel", "plain"))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kind", choices=tuple(KINDS), default="binary")
    parser.add_argument("--lr", type=float, default=3e-5)
    parser.add_argument("--steps", type=int, default=STEPS)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: run on an NVIDIA GPU, or pass --device cpu")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        torch.use_deterministic_algorithms(True, warn_only=True)
    kernel, plain = kernel_vs_plain(args.kind, args.lr, args.steps, args.device)
    for name, traj in (("kernel", kernel), ("plain", plain)):
        print(f"{name}: losses {[round(x, 6) for x in traj.losses]}; first non-finite loss at "
              f"step {traj.first_nonfinite} ({traj.module}; {traj.op}); first non-finite "
              f"update at step {traj.first_nonfinite_update}", flush=True)
    print(f"{args.kind} at lr {args.lr:g}, {args.steps} steps on {args.device}: largest "
          f"relative loss difference kernel vs plain {max_rel_diff(plain.losses, kernel.losses):.3e}",
          flush=True)


if __name__ == "__main__":
    main()
