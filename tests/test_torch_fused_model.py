"""The fused eval configuration: the SMALL MaskTransUnet in f32 on the CPU.

The port's ``MaskTransUnet(fused_s1=True, fused_stack=True)`` (the conv
unit's and the fused stack's plain versions here) against the JAX package's
fused configuration: ``MaskTransUnet(packed_levels=2)`` with
``FUSED_S1_MODE = "interpret"`` and the stack routed through
``fused_transformer_stack(..., interpret=True)``, the patterns of
``tests/test_pallas_conv.py`` and ``tests/test_fused_stack.py``. The JAX
fused conv rounds its operands to bf16 unless ``compute_dtype`` says
otherwise, so this test passes it float32 (the port computes in the input
dtype): without that, f32 agreement stops near 1e-2.

Tolerances as in ``tests/test_torch_model.py``: probabilities and masks
within atol 1e-4, the fg segmentation voxel for voxel, on seed 6, which
keeps every ROI mask value and class margin of this configuration clear of
its threshold by more than 1e-5 (checked below). The port's fused and
default configurations agree the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu.ops import pallas_conv as pcv
from lintransunet_tpu.ops import pallas_layer as pll
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.models import MaskTransUnet
from lintransunet_tpu_torch.ops import conv_unit, fused_stack
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)

ATOL = 1e-4
SEED = 6


def _jax_fused(params, x):
    """JAX's fused configuration on ``x``: (probs, masks, fg)."""
    orig_conv = pcv.fused_s1_canvas
    orig_stack = pll.fused_transformer_stack
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcv, "FUSED_S1_MODE", "interpret")
        mp.setattr(pcv, "fused_s1_canvas", lambda *a, **k: orig_conv(
            *a, **{**k, "compute_dtype": jnp.float32}))
        mp.setattr(pll, "fused_stack_supported", lambda d, h, n=None: True)
        mp.setattr(pll, "fused_transformer_stack",
                   lambda x, a, w2, v, nh, interpret=False: orig_stack(
                       x, a, w2, v, nh, interpret=True))
        jmodel = JaxMaskTransUnet(**SMALL, n_layers=2, packed_levels=2)
        probs, masks = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, train=False, return_aux=True))(params, x)
        fg = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, train=False, fg_only=True))(params, x)
    return np.asarray(probs), [np.asarray(m) for m in masks], np.asarray(fg)


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((1, 64, 64, 8, 1)).astype(np.float32)
    params = random_params(JaxMaskTransUnet(**SMALL, n_layers=2), jnp.asarray(x),
                           train=False, seed=SEED)
    out = {"jax": _jax_fused(params, jnp.asarray(x))}
    launches = (conv_unit.conv_unit.launches, fused_stack.fused_transformer_stack.launches)
    for name, flags in (("fused", dict(fused_s1=True, fused_stack=True)),
                        ("default", {})):
        port = load_port(MaskTransUnet(**SMALL, n_layers=2, device="cpu", **flags),
                         params)
        calls = {"conv_unit": 0, "fused_stack": 0}
        with pytest.MonkeyPatch.context() as mp:
            for key, mod, fn in (("conv_unit", conv_unit, "conv_unit_reference"),
                                 ("fused_stack", fused_stack,
                                  "fused_transformer_stack_reference")):
                def counted(*a, _orig=getattr(mod, fn), _key=key, **k):
                    calls[_key] += 1
                    return _orig(*a, **k)
                mp.setattr(mod, fn, counted)
            with torch.inference_mode():
                probs, masks = port(t(to_ncdhw(x)), return_aux=True)
                fg = port(t(to_ncdhw(x)), return_aux=False, fg_only=True)
        out[name] = (from_ncdhw(probs.numpy()), [from_ncdhw(m.numpy()) for m in masks],
                     from_ncdhw(fg.numpy()))
        out[f"{name} calls"] = calls
    out["launches"] = (conv_unit.conv_unit.launches - launches[0],
                       fused_stack.fused_transformer_stack.launches - launches[1])
    return out


def test_seed_keeps_clear_of_thresholds(runs):
    probs, masks, _ = runs["jax"]
    levels = len(SMALL["num_layers"])
    for j, mask in enumerate(masks):
        if SMALL["is_roi_list"][levels - 2 - j]:  # mask_list is coarse -> fine
            assert np.min(np.abs(1.0 - mask[..., 0] - 0.5)) > 1e-5, j
    assert np.min(np.abs(probs[..., 1] - probs[..., 0])) > 1e-5


@pytest.mark.parametrize("against", ["jax", "default"])
def test_fused_configuration_matches(runs, against):
    got_probs, got_masks, got_fg = runs["fused"]
    want_probs, want_masks, want_fg = runs[against]
    assert got_probs.shape == want_probs.shape == (1, 64, 64, 8, 2)
    assert np.isfinite(got_probs).all()
    np.testing.assert_allclose(got_probs, want_probs, atol=ATOL, rtol=0)
    assert len(got_masks) == len(want_masks) == 4
    for got, want in zip(got_masks, want_masks):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got_fg, want_fg)
    assert 0 < got_fg.sum() < got_fg.size


def test_fused_configuration_routes_both_units(runs):
    """Two forwards: 7 conv units (input block, two DownBlock conv1s, two
    UpBlocks of two) and 8 stack calls (4 token stacks x 2) each, all on
    the plain versions of the CPU; the default configuration routes none."""
    assert runs["fused calls"] == {"conv_unit": 14, "fused_stack": 16}
    assert runs["default calls"] == {"conv_unit": 0, "fused_stack": 0}
    assert runs["launches"] == (0, 0)
