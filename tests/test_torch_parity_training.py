"""The first steps of the training trajectories of ``tools/parity_training.py``,
port against JAX on the CPU.

The binary and the multi-class recipe (``lintransunet_tpu_torch.experiments.
parity_training``: SMALL, dropout 0, f32, 64 x 64 x 16 patches of the
seeded stream, the criterion schedules and epoch-0 weights of the JAX
package's ``experiments/parity_training*.py``) run 3 steps of AdamW at lr
3e-5 in both packages from the same parameters (seeded normals in the
shapes of JAX's init, ``tests/torch_port_helpers.random_params``; the tool
itself starts from ``create_train_state``, whose init takes a minute here),
converted by ``from_flax``. Every loss is finite and within 1e-4 relative
of JAX's (measured here: 2.2e-7 binary, 1.2e-6 multi-class). The tool is
loaded by file path (``tools/`` is no package). About 45 s a recipe, most
of it JAX compiling its train step.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu_torch.experiments import parity_training as port
from torch_port_helpers import random_params

torch.set_num_threads(2)

TOOL = Path(__file__).resolve().parents[1] / "tools" / "parity_training.py"
STEPS = 3
LR = 3e-5
RTOL = 1e-4


def _tool():
    spec = importlib.util.spec_from_file_location("parity_training_tool", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("kind", list(port.KINDS))
def test_first_steps_match_jax(kind):
    tool = _tool()
    params = random_params(tool.jax_model(kind), jnp.zeros((1,) + port.PATCH + (1,)),
                           train=False)
    got, want, _ = tool.compare(kind, LR, STEPS, params=params)
    assert len(got.losses) == len(want.losses) == STEPS
    assert all(np.isfinite(got.losses)) and got.first_nonfinite is None
    assert want.first_nonfinite is None and got.first_nonfinite_update is None
    np.testing.assert_allclose(got.losses, want.losses, rtol=RTOL)
    assert port.max_rel_diff(got.losses, want.losses) <= RTOL
    # the losses move: three different steps
    assert len(set(got.losses)) == STEPS
