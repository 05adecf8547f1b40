"""The fused eval configuration: the SMALL MaskTransUnet in f32 on the CPU.

The port's ``MaskTransUnet(fused_s1=True, fused_stack=True)`` (the conv
unit's and the fused stack's plain versions here) against the JAX package's
fused configuration: ``MaskTransUnet(packed_levels=2)`` with
``FUSED_S1_MODE = "interpret"`` and the stack routed through
``fused_transformer_stack(..., interpret=True)``, the patterns of
``tests/test_pallas_conv.py`` and ``tests/test_fused_stack.py``. Both
packages' fused conv units round their operands to bf16 by default, in an
f32 model too, and both are compared as they are.

Against JAX: both round the same operands to bf16 at the same places, but
the f32 values they round come out of convolutions and norms summed in
another order, so a value within ~1e-7 of a bf16 rounding boundary lands
one bf16 ulp (2^-8 relative) apart. A few such flips in each of the seven
units carry to the output: over seeds 1-15 the probabilities differ by at
most 6.9e-3 (median 2-5e-4) and 14-42 of 32,768 fg voxels differ, all
where the class margin is that small. So probabilities and masks are held
within atol 1e-2 and the fg segmentation on at least 99.5% of voxels.

Against the port's default configuration, with the fused conv unit at
``compute_dtype=float32``, the fused routes compute the function of the
unfused ones: tolerances as in ``tests/test_torch_model.py``, probabilities
and masks within atol 1e-4, the fg segmentation voxel for voxel.

Seed 13 keeps every ROI mask value of JAX's fused run clear of its
threshold by more than 1e-5, and its class margins too (checked below).
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

# against: (atol of probabilities and masks, least share of equal fg voxels)
TOL = {"jax": (1e-2, 0.995), "default": (1e-4, 1.0)}
SEED = 13


def _jax_fused(params, x):
    """JAX's fused configuration on ``x``: (probs, masks, fg)."""
    orig_stack = pll.fused_transformer_stack
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pcv, "FUSED_S1_MODE", "interpret")
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
    fused = dict(fused_s1=True, fused_stack=True)
    for name, flags, conv_dtype in (("fused", fused, None),
                                    ("fused f32", fused, torch.float32),
                                    ("default", {}, None)):
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
            if conv_dtype is not None:
                mp.setattr(conv_unit, "conv_unit", lambda *a, _orig=conv_unit.conv_unit,
                           **k: _orig(*a, **k, compute_dtype=conv_dtype))
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
    got_probs, got_masks, got_fg = runs["fused" if against == "jax" else "fused f32"]
    want_probs, want_masks, want_fg = runs[against]
    atol, min_agreement = TOL[against]
    assert got_probs.shape == want_probs.shape == (1, 64, 64, 8, 2)
    assert np.isfinite(got_probs).all()
    np.testing.assert_allclose(got_probs, want_probs, atol=atol, rtol=0)
    assert len(got_masks) == len(want_masks) == 4
    for got, want in zip(got_masks, want_masks):
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    assert got_fg.shape == want_fg.shape
    assert np.mean(got_fg == want_fg) >= min_agreement
    assert 0 < got_fg.sum() < got_fg.size


def test_fused_configuration_routes_both_units(runs):
    """Two forwards: 7 conv units (input block, two DownBlock conv1s, two
    UpBlocks of two) and 8 stack calls (4 token stacks x 2) each, all on
    the plain versions of the CPU; the default configuration routes none."""
    assert runs["fused calls"] == {"conv_unit": 14, "fused_stack": 16}
    assert runs["default calls"] == {"conv_unit": 0, "fused_stack": 0}
    assert runs["launches"] == (0, 0)
