"""The port's conv unit (``ops/conv_unit.py``) against the JAX package's
fused conv kernel, in f32 on the CPU.

The same numpy inputs go to the port's ``conv_unit`` (on a CPU tensor: its
plain version; ``compute_dtype=float32``) on ``(N, C, H, W, D)`` tensors and
to JAX
``fused_s1_canvas(..., interpret=True, compute_dtype=float32)`` on the
packed folded or paired canvas, converted with the JAX package's own pack
and canvas helpers (as ``tests/test_pallas_conv.py`` does). Tolerances, as
in that file: rtol / atol 2e-5 on y and z (f32, sums in another order),
rtol 1e-4 / atol 1e-3 on the statistics (sums of a few thousand O(1)
values in another order). The affine helpers agree within rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.ops import packed_conv as pc
from lintransunet_tpu.ops import pallas_conv as pcv
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.ops import conv_unit as cu
from torch_port_helpers import t

torch.set_num_threads(2)

H, W, D = 8, 8, 4


def _layout(x, n, paired):
    """JAX (N, H, W, D, C) -> packed folded (N*D, H/2, W/2, 4C), or paired."""
    xf = pc.pack_folded(pc.fold_depth(jnp.asarray(x)))
    return pc.fold_pairs(xf, n) if paired else xf


def _unlayout(y, n, paired):
    if paired:
        y = pc.unfold_pairs(y, n)
    return np.asarray(pc.unfold_depth(pc.unpack_folded(y), n))


def _lanes(v, paired):
    """Per-channel (n, C) -> per-lane (n, L) of the packed layout."""
    lanes = jnp.repeat(jnp.asarray(v), 4, axis=-1)
    return jnp.tile(lanes, (1, 2)) if paired else lanes


def _channel_stats(stats, c, paired):
    """Per-lane (n, 2, L) sums -> per-channel (n, 2, C) sums."""
    n = stats.shape[0]
    if paired:
        return np.asarray(stats).reshape(n, 2, 2, c, 4).sum(axis=(2, 4))
    return np.asarray(stats).reshape(n, 2, c, 4).sum(axis=3)


def _lane_stats(y_layout, n):
    rows = y_layout.shape[0]
    yr = np.asarray(y_layout).reshape(n, rows // n, -1, y_layout.shape[-1])
    return np.stack([yr.sum(axis=(1, 2)), (yr * yr).sum(axis=(1, 2))], axis=1)


def _inputs(rng, n, ca, cb, o):
    xa = rng.standard_normal((n, H, W, D, ca)).astype(np.float32)
    xb = rng.standard_normal((n, H, W, D, cb)).astype(np.float32) if cb else None
    k = (rng.standard_normal((3, 3, 3, ca + cb, o)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    return xa, xb, k, b


def _weight(k):
    """flax (kh, kw, kd, I, O) -> port (O, I, kh, kw, kd)."""
    return t(np.transpose(k, (4, 3, 0, 1, 2)))


@pytest.mark.parametrize("case,paired,n", [
    ("single", False, 1), ("single", True, 2),
    ("dual", True, 1), ("dual", False, 2),
    ("prologue", True, 2), ("prologue", False, 1),
])
def test_conv_unit_matches_jax_fused_s1(case, paired, n):
    rng = np.random.default_rng(sum(map(ord, case)) + 10 * n + paired)
    ca, o = 4, 5
    cb = 3 if case == "dual" else 0
    xa, xb, k, b = _inputs(rng, n, ca, cb, o)
    kp = pc.pack_kernel_stride1_jnp(jnp.asarray(k))
    bias_l = _lanes(jnp.asarray(b)[None], paired)[0]
    jax_kw = dict(bias=bias_l, n_volumes=n, h=H // 2, w=W // 2,
                  mode="paired" if paired else "folded", want_stats=True,
                  interpret=True, compute_dtype=jnp.float32)
    port_kw = dict(bias=t(b), compute_dtype=torch.float32)
    if case == "dual":
        jax_kw.update(xb=pcv.to_canvas(_layout(xb, n, paired), n),
                      packed_kernel_b=kp[:, :, :, 4 * ca:])
        kp = kp[:, :, :, :4 * ca]
        port_kw.update(xb=t(to_ncdhw(xb)), wb=_weight(k)[:, ca:])
    wa = _weight(k)[:, :ca]
    if case == "prologue":
        # the affine of the previous unit's statistics, as the model makes it
        lane_stats = _lane_stats(_layout(xa, n, paired), n)
        count = D * H * W
        scale_l, shift_l = pcv.stats_to_affine(
            jnp.asarray(lane_stats), ca, count, paired=paired)
        jax_kw.update(affine_a=jnp.stack([scale_l, shift_l], axis=1), want_z=True)
        scale, shift = cu.stats_to_affine(t(_channel_stats(lane_stats, ca, paired)), count)
        port_kw.update(affine_a=torch.stack([scale, shift], dim=1), want_z=True)

    jax_out = pcv.fused_s1_canvas(pcv.to_canvas(_layout(xa, n, paired), n), kp, **jax_kw)
    before = cu.conv_unit.launches
    port_out = cu.conv_unit(t(to_ncdhw(xa)), wa, **port_kw)
    assert cu.conv_unit.launches == before  # CPU tensors take the plain version

    y_want = _unlayout(pcv.from_canvas(jax_out[0], H // 2, W // 2, n), n, paired)
    np.testing.assert_allclose(from_ncdhw(port_out[0].numpy()), y_want,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(port_out[1].numpy(),
                               _channel_stats(jax_out[1], o, paired),
                               rtol=1e-4, atol=1e-3)
    if case == "prologue":
        z_want = _unlayout(pcv.from_canvas(jax_out[2], H // 2, W // 2, n), n, paired)
        np.testing.assert_allclose(from_ncdhw(port_out[2].numpy()), z_want,
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("paired", [False, True])
def test_affine_helpers_match_jax(rng, paired):
    n, c = 2, 3
    y = rng.standard_normal((n, H, W, D, c)).astype(np.float32) * 2.0 + 0.5
    y_l = _layout(y, n, paired)
    lane_stats = _lane_stats(y_l, n)
    count = D * H * W
    scale_l, shift_l = pcv.stats_to_affine(jnp.asarray(lane_stats), c, count,
                                           paired=paired)
    scale, shift = cu.stats_to_affine(t(_channel_stats(lane_stats, c, paired)), count)
    np.testing.assert_allclose(np.asarray(_lanes(scale.numpy(), paired)),
                               np.asarray(scale_l), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(_lanes(shift.numpy(), paired)),
                               np.asarray(shift_l), rtol=1e-5, atol=1e-6)
    want = _unlayout(pcv.apply_affine_leaky(y_l, scale_l, shift_l, n), n, paired)
    got = cu.apply_affine_leaky(t(to_ncdhw(y)), scale, shift)
    np.testing.assert_allclose(from_ncdhw(got.numpy()), want, rtol=1e-5, atol=1e-6)
