"""Training-trajectory parity of the port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/parity_training.py

Both packages train the SMALL ``MaskTransUnet`` (dropout 0, f32) in lockstep
on the same seeded 64 x 64 x 16 stream from the same parameters: JAX's
``create_train_state(model, PRNGKey(0), ...)``, converted for the port by
``compat.from_flax``. The recipe is the JAX package's
``experiments/parity_training.py`` and ``parity_training_multiclass.py``
(``lintransunet_tpu_torch.experiments.parity_training`` holds the port's
copy): binary at lr 3e-5 and 1e-4, multi-class at lr 3e-5, 40 steps each;
then binary at lr 1e-4 from torch's default layer init, the law of the
torch reference's init from which the JAX package's record went non-finite.
Each run writes its record next to this file, ``parity_training_lr{lr}.json``
(binary; ``..._torch_init.json`` for the last) or
``parity_training_multiclass_lr{lr}.json``: both loss trajectories, the
largest relative loss difference over the steps where both are finite, and
for each stack the first step whose loss is not finite, the module that
``nan_guard`` names at that step (each package's ``utils.debug.nan_guard``
on every module's output in a rerun of that step's forward from the
parameters it started from; the port's also names the first ATen op) and
the first step after whose update a parameter is not finite. The JAX package's own records under
``experiments/`` were taken against the torch reference and stay as they
are.

This is the one file outside ``tests/`` that imports both packages. It runs
on the CPU only (~10 minutes here); the card has no JAX, and
``chip_smoke.py`` phase 14 holds the port's kernels against its plain path
over the same 40 steps there.
"""

import argparse
import contextlib
import io
import json
import math
import os
import sys
import time
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import flax.linen as nn  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from lintransunet_tpu import engine as jax_engine  # noqa: E402
from lintransunet_tpu.losses import binary as jax_binary  # noqa: E402
from lintransunet_tpu.losses import multiclass as jax_multiclass  # noqa: E402
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet  # noqa: E402
from lintransunet_tpu.utils.debug import nan_guard as jax_nan_guard  # noqa: E402
from lintransunet_tpu_torch.compat import from_flax  # noqa: E402
from lintransunet_tpu_torch.experiments import parity_training as port  # noqa: E402

# (kind, lr, initial parameters): "jax" is create_train_state's PRNGKey(0)
# init; "torch" draws torch's own default layer init (kaiming-uniform weights
# and biases, the law of the torch reference's init) into the port's model
# under torch.manual_seed(0), for both stacks.
RUNS = (("binary", 3e-5, "jax"), ("binary", 1e-4, "jax"), ("multiclass", 3e-5, "jax"),
        ("binary", 1e-4, "torch"))
HERE = Path(__file__).resolve().parent


def jax_model(kind):
    return JaxMaskTransUnet(**port.SMALL, dim_output=port.KINDS[kind].classes, dropout=0.0)


def jax_state(kind, lr, params=None):
    """JAX's train state at ``lr``: ``create_train_state`` from PRNGKey(0),
    or over ``params``."""
    model = jax_model(kind)
    if params is None:
        x0 = jnp.zeros((1,) + port.PATCH + (1,), jnp.float32)
        return jax_engine.create_train_state(model, jax.random.PRNGKey(0), x0,
                                             learning_rate=lr, step_times=1)
    return jax_engine.TrainState.create(apply_fn=model.apply, params=params,
                                        tx=jax_engine.make_optimizer(lr, 1))


def torch_law_params(kind, like):
    """The port's SMALL model with torch's default layer init drawn under
    ``torch.manual_seed(0)``, as a flax tree shaped as ``like``."""
    model = port.build_model(kind, "cpu", "plain")
    with torch.random.fork_rng():
        torch.manual_seed(0)
        for module in model.modules():
            for base in (torch.nn.Conv3d, torch.nn.Conv2d, torch.nn.Linear):
                if isinstance(module, base):
                    base.reset_parameters(module)
    return to_flax(model.state_dict(), like)


def to_flax(state_dict, like, prefix=()):
    """The inverse of ``compat.from_flax``: a port state_dict as a flax
    params tree shaped as ``like``."""
    out = {}
    for key, value in like.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out[key] = to_flax(state_dict, value, prefix + (key,))
            continue
        name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[key]
        arr = state_dict[".".join(prefix + (name,))].numpy()
        if key == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(
                tuple(range(2, arr.ndim)) + (1, 0))
        if arr.shape != np.shape(value):
            raise ValueError(f"{'/'.join(prefix + (key,))}: {arr.shape} for {np.shape(value)}")
        out[key] = jnp.asarray(arr)
    return out


def jax_first_nonfinite_module(model, params, image, rng):
    """The first module whose train-mode output is not finite, as JAX's
    ``nan_guard`` on every module's ``__call__`` output names it (an
    unjitted apply); "loss" if none is."""
    def guard(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if context.method_name == "__call__":
            name = ".".join(context.module.path) or "model"
            for leaf in jax.tree.leaves(out):
                if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
                    jax_nan_guard(leaf, name)
        return out

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), nn.intercept_methods(guard):
        model.apply({"params": params}, image, train=True, rngs={"dropout": rng})
        jax.effects_barrier()
    lines = printed.getvalue().splitlines()
    return lines[0].split("non-finite values in ", 1)[1] if lines else "loss"


def jax_run(kind, state, steps, data):
    """JAX's ``make_train_step`` over ``steps`` items of ``data``, as the
    JAX package's scripts run it: a ``port.Trajectory``."""
    recipe = port.KINDS[kind]
    multi = kind == "multiclass"
    module = jax_multiclass if multi else jax_binary
    model = jax_model(kind)
    criterions = [module.get_criterions(list(names)) for names in recipe.criteria]
    step = jax_engine.make_train_step(
        model, criterions, criterion_weight=list(recipe.criterion_weight) if multi else None,
        num_classes=recipe.classes if multi else None, donate=False)
    dynamic_weight = jnp.asarray(recipe.dynamic_weight, jnp.float32)
    rng = jax.random.PRNGKey(7)  # dropout 0: inert
    images, labels = data
    out = port.Trajectory(losses=[])
    for t in range(steps):
        image = jnp.asarray(images[t][..., None][None])
        start = state.params
        state, loss, _ = step(state, image, jnp.asarray(labels[t][None]), dynamic_weight, rng)
        out.losses.append(float(loss))
        if out.first_nonfinite is None and not math.isfinite(out.losses[-1]):
            out.first_nonfinite = t
            out.module = jax_first_nonfinite_module(model, start, image, rng)
        if out.first_nonfinite_update is None and not all(
                bool(jnp.all(jnp.isfinite(p))) for p in jax.tree.leaves(state.params)):
            out.first_nonfinite_update = t
    return out


def port_run(kind, params, lr, steps, data):
    """The port's plain step on the CPU from the same parameters."""
    model = port.build_model(kind, "cpu", "plain",
                             state_dict=from_flax(jax.tree.map(np.asarray, params)))
    return port.run(kind, model, lr, steps, data)


def compare(kind, lr, steps, params=None, init="jax"):
    """(port trajectory, JAX trajectory, seconds each) of one run from
    ``params``, or else from ``init``'s parameters."""
    data = port.make_data(kind, steps)
    state = jax_state(kind, lr, params)
    if params is None and init == "torch":
        state = jax_state(kind, lr, torch_law_params(kind, state.params))
    t0 = time.perf_counter()
    port_traj = port_run(kind, state.params, lr, steps, data)
    t1 = time.perf_counter()
    jax_traj = jax_run(kind, state, steps, data)
    return port_traj, jax_traj, {"port": t1 - t0, "jax": time.perf_counter() - t1}


INITS = {"jax": "JAX create_train_state(PRNGKey(0)), compat.from_flax for the port",
         "torch": "torch's default layer init (kaiming-uniform, the torch reference's law) "
                  "under torch.manual_seed(0) in the port's model, to_flax for JAX"}


def record(kind, lr, steps, port_traj, jax_traj, seconds, init="jax"):
    rel = [abs(a - b) / max(abs(a), 1e-8) for a, b in zip(port_traj.losses, jax_traj.losses)]
    both = lambda field: {"port": getattr(port_traj, field), "jax": getattr(jax_traj, field)}
    return {
        "kind": kind, "steps": steps, "lr": lr, "patch": list(port.PATCH),
        "model": "MaskTransUnet " + json.dumps(port.SMALL) + ", dropout 0, f32, CPU",
        "initial_params": INITS[init],
        "dynamic_weight": list(port.KINDS[kind].dynamic_weight),
        "port_losses": port_traj.losses, "jax_losses": jax_traj.losses,
        "max_rel_diff": port.max_rel_diff(port_traj.losses, jax_traj.losses),
        "final_rel_diff": rel[-1],
        "first_nonfinite_step": both("first_nonfinite"),
        "first_nonfinite_module": both("module"),
        "first_nonfinite_op": {"port": port_traj.op, "jax": None},
        "first_nonfinite_update": both("first_nonfinite_update"),
        "seconds": seconds,
        "versions": {"torch": torch.__version__, "jax": jax.__version__},
    }


def main():
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")  # as the JAX scripts ran
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    for kind, lr, init in RUNS:
        port_traj, jax_traj, seconds = compare(kind, lr, port.STEPS, init=init)
        out = record(kind, lr, port.STEPS, port_traj, jax_traj, seconds, init)
        name = "parity_training" + ("_multiclass" if kind == "multiclass" else "")
        path = HERE / f"{name}_lr{lr:g}{'_torch_init' if init == 'torch' else ''}.json"
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        print(f"{kind} lr {lr:g}, {init} init: largest relative loss difference "
              f"{out['max_rel_diff']:.3e}; first non-finite loss {out['first_nonfinite_step']} "
              f"({out['first_nonfinite_module']}, {out['first_nonfinite_op']}); first "
              f"non-finite update "
              f"{out['first_nonfinite_update']}; {seconds['port']:.0f} s port, "
              f"{seconds['jax']:.0f} s JAX; wrote {path}", flush=True)


if __name__ == "__main__":
    main()
