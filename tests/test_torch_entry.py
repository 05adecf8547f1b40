"""The port's entry points (``lintransunet_tpu_torch.entry``) against
the JAX package's ``__graft_entry__.py``, on the CPU.

* ``entry(device="cpu")``: the flagship's bf16 eval forward on the zero
  96^3 patch gives the shape and dtype of ``jax.eval_shape`` of
  ``__graft_entry__._flagship()``'s ``apply(..., train=False)`` (its init
  also through ``eval_shape``), channels first, a one-hot per voxel.
* ``dryrun_multichip(2, device="cpu")`` on two gloo ranks passes every
  held check and prints JAX's four "ok" lines. It runs in f32: this CPU's
  bf16 ``conv3d`` returns NaN now and then for an all-zero input at the
  ROI bridges' shapes (a (2, 128, 30, 18, 2) input, stride 2, padding 1,
  reproduced with ``F.conv3d`` alone), so a bf16 dry run here can fail for
  the library, not the port; the card runs it in bf16 (``chip_smoke.py``
  phase 15c).
* Without a card, the defaults raise.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from lintransunet_tpu_torch import entry

torch.set_num_threads(4)

REPO = Path(__file__).resolve().parent.parent


def _graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_entry_output_matches_jax_eval_shape():
    model = _graft_entry()._flagship()
    x = jnp.zeros((1, 96, 96, 96, 1), jnp.bfloat16)
    variables = jax.eval_shape(lambda k: model.init(k, x, train=False), jax.random.PRNGKey(0))
    want = jax.eval_shape(lambda v, p: model.apply(v, p, train=False), variables, x)

    fn, (port, patch) = entry.entry(device="cpu")
    assert patch.shape == (1, 1, 96, 96, 96) and patch.dtype == torch.bfloat16
    assert not port.training
    out = fn(port, patch)
    assert tuple(out.shape) == (want.shape[0], want.shape[-1]) + tuple(want.shape[1:-1])
    assert out.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert torch.isfinite(out).all()
    assert torch.equal(out.float().sum(dim=1), torch.ones((1, 96, 96, 96)))


def test_dryrun_multichip_on_two_cpu_ranks(capfd):
    entry.dryrun_multichip(2, device="cpu", dtype=torch.float32)
    lines = [line for line in capfd.readouterr().out.splitlines()
             if line.startswith("dryrun_multichip(2)")]
    assert [line.split(" ok")[0] for line in lines] == [
        "dryrun_multichip(2) train", "dryrun_multichip(2) binary",
        "dryrun_multichip(2) multi-class train", "dryrun_multichip(2)"]
    assert "eval_sum=" in lines[1] and "mc_kept=" in lines[3]


def test_entry_points_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)
