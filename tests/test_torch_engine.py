"""PyTorch port vs the JAX package: sliding-window inference on the CPU.

* The grid helpers give the same windows, importance and normalisation.
* The port's runner (``make_eval_runner``: fg-only forward, canvas blend,
  derived background) with the SMALL model equals the JAX runner (static
  depth-region blend) voxel for voxel on a 5-window volume.
* ``sliding_window_inference`` with a fixed cheap predictor, in gaussian
  and constant mode on an H/W-tiled grid, matches JAX to f32 rounding
  (rtol 1e-6 / atol 1e-6: the same windows summed in the same order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import engine as jeng
from lintransunet_tpu.cli.common import make_eval_runner as jax_make_eval_runner
from lintransunet_tpu.core.config import EvalConfig as JaxEvalConfig
from lintransunet_tpu.engine import sliding_window as jsw
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.cli.common import EvalConfig, make_eval_runner
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.engine import sliding_window as tsw
from lintransunet_tpu_torch.models import MaskTransUnet
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)


@pytest.mark.parametrize("spatial,roi,overlap", [
    ((100, 64, 20), (64, 64, 8), 0.6),
    ((512, 512, 144), (512, 512, 64), 0.6),
    ((12, 10, 9), (8, 8, 4), 0.5),
])
def test_grid_helpers_match_jax(spatial, roi, overlap):
    assert tsw.scan_interval(spatial, roi, overlap) == jsw.scan_interval(
        spatial, roi, overlap)
    np.testing.assert_array_equal(
        tsw.dense_window_starts(spatial, roi, overlap),
        jsw.dense_window_starts(spatial, roi, overlap))
    assert tsw.padded_spatial_shape((5, 70, 3), roi) == jsw.padded_spatial_shape(
        (5, 70, 3), roi)
    if np.prod(spatial) < 1e6:
        for mode in ("constant", "gaussian"):
            np.testing.assert_array_equal(
                tsw.normalisation_map(spatial, roi, overlap, mode, 0.125).numpy(),
                jsw.normalisation_map(spatial, roi, overlap, mode, 0.125))
    np.testing.assert_array_equal(tsw.gaussian_importance(roi[:2] + (4,), 0.125),
                                  jsw.gaussian_importance(roi[:2] + (4,), 0.125))


def test_runner_matches_jax_runner_voxel_for_voxel(monkeypatch):
    """5 windows in depth (20 slices, roi depth 8, overlap 0.6) on the
    serving geometry: one window in H and W, constant blending."""
    # the JAX runner's unrolled static blend compiles five forwards; its
    # scan form computes the same windows with one
    monkeypatch.setattr(jsw, "STATIC_UNROLL_MAX", 0)
    rng = np.random.default_rng(6)
    vol = rng.standard_normal((1, 64, 64, 20, 1)).astype(np.float32)
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2)
    params = random_params(jmodel, jnp.zeros((1, 64, 64, 8, 1)), train=False,
                           seed=6)
    _, jrunner = jax_make_eval_runner(jmodel, JaxEvalConfig(64, 8))
    want = np.asarray(jrunner(jnp.asarray(vol), params))

    port = load_port(MaskTransUnet(**SMALL, n_layers=2, device="cpu"), params)
    fwd, runner = make_eval_runner(port, EvalConfig(64, 8))
    assert fwd.fg_only
    assert runner.device == torch.device("cpu")  # the model's device
    got = from_ncdhw(runner(t(to_ncdhw(vol))).numpy())
    assert got.shape == want.shape == (1, 64, 64, 20, 2)
    np.testing.assert_array_equal(got, want)
    assert 0 < got[..., 1].mean() < 1


def _jax_predictor(x):
    return jnp.concatenate([x * 2.0, x[..., :1] - 1.0], axis=-1)


def _port_predictor(x):
    return torch.cat([x * 2.0, x[:, :1] - 1.0], dim=1)


@pytest.mark.parametrize("mode", ["gaussian", "constant"])
@pytest.mark.parametrize("sw_batch", [1, 2])
def test_sliding_window_inference_tiled_grid(rng, mode, sw_batch):
    """H/W-tiled grid (windows overlap in all three dims) plus a sub-roi
    depth that takes the symmetric pad."""
    vol = rng.standard_normal((2, 12, 10, 3, 3)).astype(np.float32)
    kw = dict(overlap=0.5, mode=mode, sigma_scale=0.125)
    want = jeng.sliding_window_inference(jnp.asarray(vol), (8, 8, 4), sw_batch,
                                         _jax_predictor, **kw)
    got = tsw.sliding_window_inference(t(to_ncdhw(vol)), (8, 8, 4), sw_batch,
                                       _port_predictor, **kw)
    np.testing.assert_allclose(from_ncdhw(got.numpy()), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def _depth_region_blend(vol, roi, overlap, predictor):
    """Constant blend of a volume whose (H, W) equal the roi's, by depth
    regions: between consecutive window-boundary depths every voxel is
    covered by the same windows, so the output there is the mean of their
    slices. This is the JAX package's static depth-region blend."""
    depth, rd = vol.shape[4], roi[2]
    pad = max(rd - depth, 0)
    x = torch.nn.functional.pad(vol, (pad // 2, pad - pad // 2))
    starts = tsw.dense_window_starts(x.shape[2:], roi, overlap)[:, 2]
    preds = {int(s): predictor(x[..., s:s + rd]) for s in starts}
    bounds = sorted(set(preds) | {s + rd for s in preds})
    segs = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        members = [p[..., a - s:b - s] for s, p in preds.items()
                   if s <= a and b <= s + rd]
        segs.append(sum(members[1:], members[0]) / len(members))
    return torch.cat(segs, dim=4)[..., pad // 2:pad // 2 + depth]


@pytest.mark.parametrize("depth", [10, 3])
def test_static_blend_equals_canvas_blend(rng, depth):
    """On the serving geometry (one window in H and W, constant blending)
    the runner's canvas blend is bit-identical to the depth-region blend
    (overlapping grid; sub-roi pad), with and without derived background."""
    vol = t(to_ncdhw(rng.standard_normal((2, 8, 8, depth, 3)).astype(np.float32)))
    want = _depth_region_blend(vol, (8, 8, 4), 0.6, _port_predictor)
    runner = tsw.SlidingWindowRunner(_port_predictor, (8, 8, 4), overlap=0.6)
    np.testing.assert_array_equal(runner(vol).numpy(), want.numpy())
    bg_runner = tsw.SlidingWindowRunner(lambda x: _port_predictor(x)[:, :1],
                                        (8, 8, 4), overlap=0.6,
                                        derive_background=True)
    fg = want[:, :1]
    np.testing.assert_array_equal(bg_runner(vol).numpy(),
                                  torch.cat([1.0 - fg, fg], dim=1).numpy())


def test_runner_rejects_bad_arguments():
    with pytest.raises(ValueError):
        tsw.SlidingWindowRunner(_port_predictor, (8, 8, 4), sw_batch_size=0)
    with pytest.raises(ValueError):
        tsw.SlidingWindowRunner(_port_predictor, (8, 8, 4), mode="linear")
    with pytest.raises(ValueError):
        tsw.SlidingWindowRunner(_port_predictor, (8, 8))
