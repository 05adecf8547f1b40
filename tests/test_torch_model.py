"""PyTorch port vs the JAX package: the whole SMALL MaskTransUnet in f32.

Same seeded parameters and input in both. The probabilities and the four
deep-supervision masks agree within atol 1e-4: twenty-odd conv / norm /
attention layers in f32, each summing in another order, leave ~1e-6
differences that the InstanceNorms and LayerNorms can scale up by their
1/std. The fg-only hard segmentation agrees voxel for voxel. The seed is
checked to keep every ROI mask value and every class margin clear of its
decision threshold by more than 1e-5, so a tie cannot decide the result:
seed 6 does (seeds 4, 5 and 7 put a class margin within 1e-5; seed 0 gives
a non-finite fisheye warp at level 3 in both packages alike).
SMALL's odd eval ROI sizes (roi 8 -> eval 9 x 5) take the back-warp's
"eval + 1 rows" branch, which the flagship never reaches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.models import MaskTransUnet
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)

ATOL = 1e-4
SEED = 6


@pytest.fixture(scope="module")
def both():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((1, 64, 64, 8, 1)).astype(np.float32)
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=SEED)
    aux = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=False, return_aux=True))
    fg = jax.jit(lambda p, v: jmodel.apply(
        {"params": p}, v, train=False, fg_only=True))
    want_probs, want_masks = aux(params, jnp.asarray(x))
    want_fg = fg(params, jnp.asarray(x))
    port = load_port(MaskTransUnet(**SMALL, n_layers=2, device="cpu"), params)
    with torch.inference_mode():
        got_probs, got_masks = port(t(to_ncdhw(x)), return_aux=True)
        got_fg = port(t(to_ncdhw(x)), return_aux=False, fg_only=True)
    return dict(want_probs=np.asarray(want_probs),
                want_masks=[np.asarray(m) for m in want_masks],
                want_fg=np.asarray(want_fg), got_probs=got_probs.numpy(),
                got_masks=[m.numpy() for m in got_masks], got_fg=got_fg.numpy())


def test_seed_keeps_clear_of_thresholds(both):
    levels = len(SMALL["num_layers"])
    for j, mask in enumerate(both["want_masks"]):
        if SMALL["is_roi_list"][levels - 2 - j]:  # mask_list is coarse -> fine
            foreground = 1.0 - mask[..., 0]
            assert np.min(np.abs(foreground - 0.5)) > 1e-5, j
    probs = both["want_probs"]
    assert np.min(np.abs(probs[..., 1] - probs[..., 0])) > 1e-5


def test_probabilities_and_masks_match_jax(both):
    assert both["got_probs"].shape == (1, 2, 64, 64, 8)
    assert np.isfinite(both["got_probs"]).all()
    np.testing.assert_allclose(from_ncdhw(both["got_probs"]),
                               both["want_probs"], atol=ATOL, rtol=0)
    assert len(both["got_masks"]) == len(both["want_masks"]) == 4
    for got, want in zip(both["got_masks"], both["want_masks"]):
        np.testing.assert_allclose(from_ncdhw(got), want, atol=ATOL, rtol=0)


def test_model_without_cuda_raises_unless_asked_for_cpu(monkeypatch):
    """The card is the default device: with no CUDA device visible the
    model raises, and builds on the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskTransUnet(**SMALL)
    model = MaskTransUnet(**SMALL, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_fg_only_segmentation_matches_jax_exactly(both):
    got = from_ncdhw(both["got_fg"])
    assert got.shape == both["want_fg"].shape == (1, 64, 64, 8, 1)
    np.testing.assert_array_equal(got, both["want_fg"])
    # both classes occur, so the comparison is not trivially all-background
    assert 0 < got.sum() < got.size
