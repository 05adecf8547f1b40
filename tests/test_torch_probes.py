"""The port's conv probes (``lintransunet_tpu_torch/experiments``) against the
JAX package's TPU probes (``experiments/*.py``), on the CPU.

Each port function runs its plain PyTorch version (CPU tensors); the JAX
side runs the TPU probe's Pallas kernel in interpret mode, or its own
reference where the probe runs a TPU benchmark at import. Inputs come from
numpy with a seed. Tolerances, each a share of max |JAX|:

* f32: 1e-5 (the same f32 products summed in another order);
* bf16 outputs: 8e-3 (both sides sum exact products of bf16 operands in
  f32 and round once to bf16, so a value near a rounding boundary can
  land one bf16 ulp, 2^-8 of its magnitude, apart);
* variant E of the dot probe: one bf16 ulp of max |JAX| per add (each side
  rounds every tap's product and every partial sum to bf16, and JAX's CPU
  dot may round its product from another f32 sum than the port's); and its
  mean distance to JAX's bf16-accumulated sum at most
  ``dot_probe.E_ROUNDING_SHARE`` of the mean gap between that sum and the
  f32-accumulated one, so that a sum in f32 fails;
* InstanceNorm lane sums and statistics: 1e-5 relative (f32 sums of up to
  ~16k values in another order).
"""

import functools
import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from lintransunet_tpu.ops.packed_conv import packed_conv3d_stride1
from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    rowoffset_probe,
)

EXPERIMENTS = Path(__file__).resolve().parent.parent / "experiments"
F32_TOL = 1e-5
BF16_TOL = 8e-3


def _jax_probe(name):
    """A TPU probe module of ``experiments/``, loaded from its file (the
    directory is not a package)."""
    spec = importlib.util.spec_from_file_location(f"jax_probe_{name}", EXPERIMENTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def retired():
    return _jax_probe("pallas_conv_retired")


@pytest.fixture(scope="module")
def rowoffset():
    return _jax_probe("pallas_rowoffset_probe")


@pytest.fixture(scope="module")
def inner():
    return _jax_probe("pallas_inner_probe")


@pytest.fixture(scope="module")
def in_stats():
    return _jax_probe("in_stats_probe")


def _err(got, want):
    """max |got - want| over max |want|, in f32."""
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _pair(array, dtype):
    """The same values as a torch tensor and a jax array of ``dtype``."""
    j = jnp.asarray(array, dtype)
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32), j


# ---- #7 experiments/pallas_conv_retired.py ---------------------------------

@pytest.mark.parametrize("reference", ["pallas_interpret", "packed_conv3d_stride1"])
def test_conv_rows_matches_jax(retired, reference):
    rng = np.random.default_rng(0)
    xp, xp_j = _pair(rng.standard_normal((1, 8, 8, 8, 16)), jnp.float32)
    k, k_j = _pair(rng.standard_normal((3, 3, 3, 16, 16)) * 0.2, jnp.float32)
    b, b_j = _pair(rng.standard_normal(16) * 0.1, jnp.float32)
    if reference == "pallas_interpret":
        want = retired.packed_conv3d_stride1_pallas(xp_j, k_j, b_j, interpret=True)
    else:
        want = packed_conv3d_stride1(xp_j, k_j, b_j)
    got = conv_retired.conv3d_cl_rows(xp, k, b)
    assert got.shape == tuple(want.shape)
    assert _err(got, want) <= F32_TOL


# ---- #6 experiments/pallas_conv_prototype.py (its reference, :117) ----------

@pytest.mark.parametrize("shape,n_out", [((8, 8, 16, 16), 16), ((6, 10, 8, 8), 24)])
def test_conv_halo_matches_jax(shape, n_out):
    """Held to the probe's own reference: importing the probe runs its TPU
    benchmark."""
    rng = np.random.default_rng(1)
    x, x_j = _pair(rng.standard_normal(shape), jnp.float32)
    k, k_j = _pair(rng.standard_normal((3, 3, 3, shape[-1], n_out)) * 0.2, jnp.float32)
    want = jax.lax.conv_general_dilated(x_j[None], k_j, (1, 1, 1), [(1, 1)] * 3,
                                        dimension_numbers=("NHWDC", "HWDIO", "NHWDC"))[0]
    got = conv_prototype.conv3d_cl(x, k)
    assert got.shape == tuple(want.shape)
    assert _err(got, want) <= F32_TOL


# ---- #8 experiments/pallas_rowoffset_probe.py -------------------------------

def _rowoffset_jax(mod, offsets, x, w):
    """The probe's pallas_call, built as ``build`` (:48-65) builds it, over
    a grid of x.shape[0] tiles, in interpret mode."""
    return pl.pallas_call(
        mod.make_kernel(offsets),
        grid=(x.shape[0],),
        in_specs=[pl.BlockSpec((1, mod.M_PAD, mod.K), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((9, mod.K, mod.N), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, mod.M, mod.N), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((x.shape[0], mod.M, mod.N), x.dtype),
        interpret=True,
    )(x, w)


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, F32_TOL), (jnp.bfloat16, BF16_TOL)])
@pytest.mark.parametrize("variant", sorted(rowoffset_probe.OFFSETS))
def test_row_offset_sum_matches_jax(rowoffset, variant, dtype, tol):
    offsets = rowoffset_probe.OFFSETS[variant]
    assert (rowoffset.M, rowoffset.M_PAD, rowoffset.K, rowoffset.N) == (
        rowoffset_probe.M, rowoffset_probe.M_PAD, rowoffset_probe.K, rowoffset_probe.N)
    rng = np.random.default_rng(2)
    x, x_j = _pair(rng.standard_normal((2, rowoffset.M_PAD, rowoffset.K)), dtype)
    w, w_j = _pair(rng.standard_normal((9, rowoffset.K, rowoffset.N)) * 0.05, dtype)
    want = _rowoffset_jax(rowoffset, offsets, x_j, w_j)
    got = rowoffset_probe.row_offset_sum(x, w, offsets)
    assert got.dtype == x.dtype and got.shape == tuple(want.shape)
    assert _err(got, want) <= tol


# ---- #11 experiments/pallas_inner_probe.py ----------------------------------

def _inner_jax(mod, variant, hbo, z, kp, ku, kd):
    """The probe's pallas_call for one step, as ``run`` (:199-243) builds it."""
    m = hbo * mod.WC
    scratch = []
    if variant == "bext_s":
        scratch = [pltpu.VMEM(((hbo + 2) * mod.WC - 2, 3 * mod.L), mod.DT)]
    kern = mod.make_kernel(variant, hbo)
    if not scratch:
        kern = (lambda k: (lambda a, b, c, d, o: k(a, b, c, d, o)))(kern)
    return pl.pallas_call(
        kern,
        scratch_shapes=scratch,
        grid=(1,),
        in_specs=[pl.BlockSpec((3, hbo + 2, mod.WC, mod.L), lambda i: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(tuple(kp.shape), lambda i: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, 3, mod.C4, mod.C4), lambda i: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, 3, mod.C4, mod.C4), lambda i: (0, 0, 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, m, mod.NO), lambda i: (0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, m, mod.NO), mod.DT),
        interpret=True,
    )(z, kp, ku, kd)


@pytest.mark.parametrize("variant,rows", [
    ("dots27", "all"),      # the function the port computes
    ("kext", "all"),        # the same function, K-extended
    ("bext_s", "interior"), # differs from dots27 by design on the two clipped
    ("im2col", "interior"), # edge rows (rows 0 and m - 1) only
])
def test_inner_step_matches_jax(inner, variant, rows):
    hbo = 2
    assert (inner.L, inner.C4, inner.NO, inner.WC) == (
        inner_probe.L, inner_probe.C4, inner_probe.NO, inner_probe.WC)
    rng = np.random.default_rng(3)
    z, z_j = _pair(rng.standard_normal((3, hbo + 2, inner.WC, inner.L)), jnp.bfloat16)
    kp, kp_j = _pair(rng.standard_normal((3, 3, inner.L, inner.NO)) * 0.05, jnp.bfloat16)
    ku, ku_j = _pair(rng.standard_normal((3, 3, inner.C4, inner.C4)) * 0.05, jnp.bfloat16)
    kd, kd_j = _pair(rng.standard_normal((3, 3, inner.C4, inner.C4)) * 0.05, jnp.bfloat16)
    kw_j = kp_j
    if variant == "kext":
        kw_j = jnp.asarray(inner_probe.pack_weights(kp, ku, kd).float().reshape(
            3, 3, 2 * inner.L, inner.NO).numpy(), jnp.bfloat16)
    want = np.asarray(_inner_jax(inner, variant, hbo, z_j, kw_j, ku_j, kd_j), np.float32)
    got = inner_probe.inner_step(z, kp, ku, kd, hbo)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    if rows == "interior":
        got, want = got[:, 1:-1], want[:, 1:-1]
    assert _err(got, want) <= BF16_TOL


def test_inner_step_batches_windows():
    rng = np.random.default_rng(4)
    z = torch.from_numpy(rng.standard_normal((2, 3, 4, inner_probe.WC, inner_probe.L))
                         .astype(np.float32)).bfloat16()
    kp = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32) * 0.05)
    ku, kd = (torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05)
              for _ in range(2))
    batched = inner_probe.inner_step(z, kp, ku, kd, 2)
    for b in range(2):
        torch.testing.assert_close(batched[b:b + 1], inner_probe.inner_step(z[b], kp, ku, kd, 2),
                                   rtol=0, atol=0)


# ---- #9 experiments/in_stats_probe.py ---------------------------------------

@pytest.fixture
def in_stats_interpret(in_stats, monkeypatch):
    """The probe module with its ``pl.pallas_call`` in interpret mode;
    monkeypatch puts the module's ``pl`` back afterwards."""
    monkeypatch.setattr(in_stats, "pl", types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec))
    return in_stats


STATS_CASES = [("L0-paired", (4, 16, 8, 128), 16, 1, (2, -1, 4), 1.0),
               ("L1dec-folded", (4, 16, 8, 256), 64, 2, (-1, 4), 0.9)]


@pytest.mark.parametrize("label,shape,channels,n,sub,scale", STATS_CASES)
def test_lane_sums_match_jax(in_stats_interpret, label, shape, channels, n, sub, scale):
    rng = np.random.default_rng(5)
    x, x_j = _pair(rng.standard_normal(shape) * 3 + 1, jnp.bfloat16)
    want = np.asarray(in_stats_interpret._pallas_lane_sums(x_j, scale))
    got = in_stats_probe.lane_sums(x, scale)
    assert got.dtype == torch.float32 and got.shape == want.shape
    for part in (0, 1):
        assert _err(got[:, :, part], want[:, :, part]) <= F32_TOL


@pytest.mark.parametrize("label,shape,channels,n,sub,scale", STATS_CASES)
@pytest.mark.parametrize("port,jax_name", [("stats_lane", "stats_lane"),
                                           ("stats_from_lane_sums", "stats_pallas"),
                                           ("stats_from_lane_sums", "stats_cur")])
def test_in_stats_match_jax(in_stats_interpret, port, jax_name, label, shape, channels, n,
                            sub, scale):
    rng = np.random.default_rng(6)
    x, x_j = _pair(rng.standard_normal(shape) * 3 + 1, jnp.bfloat16)
    want = getattr(in_stats_interpret, jax_name)(x_j, channels, n, sub, scale=scale)
    got = getattr(in_stats_probe, port)(x, channels, n, sub, scale=scale)
    for g, w in zip(got, want):
        assert g.shape == tuple(w.shape)
        assert _err(g, w) <= F32_TOL


# ---- #10 experiments/pallas_dot_probe.py (its kernel body, :31-37) ----------

def _dot_jax(x, w, acc_dtype):
    """The body of ``bench``'s kernel: sum of jax.lax.dot over the taps in
    ``acc_dtype``, stored in x's dtype."""
    acc = jnp.zeros((x.shape[0], x.shape[1], w.shape[2]), acc_dtype)
    for t in range(w.shape[0]):
        acc = acc + jax.lax.dot_general(x, w[t], (((2,), (0,)), ((), ())),
                                        preferred_element_type=acc_dtype)
    return acc.astype(x.dtype)


@pytest.mark.parametrize("name,taps,k,n,acc", dot_probe.VARIANTS)
def test_tap_sum_matches_jax(name, taps, k, n, acc):
    rng = np.random.default_rng(7)
    if acc == torch.bfloat16:  # variant E: bf16 operands, bf16 accumulation
        x, x_j = _pair(rng.standard_normal((2, 64, k)), jnp.bfloat16)
        w, w_j = _pair(rng.standard_normal((taps, k, n)) * 0.05, jnp.bfloat16)
        want = np.asarray(_dot_jax(x_j, w_j, jnp.bfloat16), np.float32)
        top = np.abs(want).max()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
        tol = taps * ulp / top
    else:
        x, x_j = _pair(rng.standard_normal((2, 64, k)), jnp.float32)
        w, w_j = _pair(rng.standard_normal((taps, k, n)) * 0.05, jnp.float32)
        want = _dot_jax(x_j, w_j, jnp.float32)
        tol = F32_TOL
    got = dot_probe.tap_sum(x, w, acc_dtype=acc)
    assert got.shape == tuple(want.shape)
    assert _err(got, want) <= tol
    if acc == torch.bfloat16:
        # the rounding after each tap is there: the port sits nearer JAX's
        # bf16-accumulated sum than its f32-accumulated one
        f32_acc = torch.from_numpy(np.asarray(_dot_jax(x_j, w_j, jnp.float32), np.float32))
        share = dot_probe.bf16_rounding_share(got, torch.from_numpy(want), f32_acc)
        assert share <= dot_probe.E_ROUNDING_SHARE


def test_tap_sum_offsets_pad_with_zeros():
    """Rows outside x read as zero, on either side."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((1, 10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 8, 16)).astype(np.float32))
    got = dot_probe.tap_sum(x, w, offsets=[-2, 3], m=10)
    padded = torch.nn.functional.pad(x, (0, 0, 2, 3))
    want = padded[:, 0:10] @ w[0] + padded[:, 5:15] @ w[1]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
