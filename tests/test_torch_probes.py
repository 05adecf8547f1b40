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


# ---- the bf16 kernel's packed weights and the wrappers' checks (#6, #7) ----

@pytest.mark.parametrize("c,o", [(32, 64), (64, 64), (128, 64), (32, 128), (64, 128),
                                 (128, 128)])
def test_pack_weights_matches_rounded_weights(c, o):
    """Packed, the weights are the bf16-rounded weights at the addresses the
    kernel reads (each output's 32 channels one 64-byte row, its 16-byte
    pieces swizzled by ``ltu::swz``); unpacked, they are those weights."""
    rng = np.random.default_rng(9)
    k = torch.from_numpy(rng.standard_normal((3, 3, 3, c, o)).astype(np.float32))
    packed = conv_prototype.pack_weights(k)
    assert packed.dtype == torch.bfloat16
    assert packed.shape == (o // 64, c // 32, 3, 3, 3, 64, 32)
    rounded = k.bfloat16()
    unpacked = torch.empty(27 * c * o, dtype=torch.bfloat16)
    unpacked[conv_prototype._packed_layout(c, o).reshape(-1)] = packed.reshape(-1)
    assert torch.equal(unpacked.view(3, 3, 3, c, o), rounded)
    og, ch, kh, kd, kw, n, col = np.meshgrid(*(np.arange(m) for m in packed.shape),
                                             indexing="ij")
    channel = ch * 32 + ((col // 8) ^ ((n >> 1) & 3)) * 8 + col % 8
    want = rounded[torch.from_numpy(kh), torch.from_numpy(kw), torch.from_numpy(kd),
                   torch.from_numpy(channel), torch.from_numpy(og * 64 + n)]
    assert torch.equal(packed, want)


def _conv_case(shape, n_out, dtype=torch.float32, k_dtype=None):
    x = torch.zeros(shape, dtype=dtype)
    k = torch.zeros((3, 3, 3, shape[-1], n_out), dtype=k_dtype or dtype)
    return x, k


@pytest.mark.parametrize("case,error", [
    (lambda: (*_conv_case((1, 4, 4, 16, 48), 64, torch.bfloat16), None), ValueError),  # C % 32
    (lambda: (*_conv_case((1, 4, 4, 16, 32), 96, torch.bfloat16), None), ValueError),  # O % 64
    (lambda: (*_conv_case((1, 4, 4, 48, 16), 64), None), ValueError),   # f32 D not in 16..128
    (lambda: (*_conv_case((1, 4, 6, 32, 16), 64), None), ValueError),   # f32 W % (128 / D)
    (lambda: (*_conv_case((4, 4, 16, 32), 64), None), ValueError),      # x not 5-D
    (lambda: (_conv_case((1, 4, 8, 16, 64), 64)[0][:, :, ::2],
              _conv_case((1, 4, 4, 16, 64), 64)[1], None), ValueError),  # not contiguous
    (lambda: (*_conv_case((1, 4, 4, 16, 32), 64, torch.bfloat16),
              torch.zeros(64, dtype=torch.bfloat16)), ValueError),      # bias not f32
    (lambda: (*_conv_case((1, 4, 4, 16, 32), 64, torch.float16), None), TypeError),
    (lambda: (*_conv_case((1, 4, 4, 16, 32), 64, torch.bfloat16, torch.float32), None),
     TypeError),                                                        # mixed dtypes
])
def test_conv_wrapper_rejects_what_the_kernel_does_not_take(case, error):
    """The checks ahead of every probe_conv launch, on the CPU; the card test
    ``test_probes_reject_what_they_do_not_take`` holds the wrappers to them."""
    x, k, bias = case()
    with pytest.raises(error):
        conv_prototype.check_inputs(x, k, bias)


def test_conv_wrapper_takes_ragged_bf16_shapes_and_wants_the_card():
    x, k = _conv_case((2, 7, 9, 48, 64), 128, torch.bfloat16)
    assert conv_prototype.check_inputs(x, k, torch.zeros(128)) is True
    with pytest.raises(ValueError):     # CPU tensors never reach the kernel
        conv_prototype.run_conv(x, k, None)


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


# ---- #11 on the card's plan: the kernel's walk, its packing, the yardstick ---

@functools.lru_cache(maxsize=None)
def _inner_case(hbo):
    """One window's z, kp, ku, kd as torch (bf16) and the TPU probe's
    ``dots27`` output on them (interpret mode), as f32 numpy."""
    inner = _jax_probe("pallas_inner_probe")
    rng = np.random.default_rng(20 + hbo)
    z, z_j = _pair(rng.standard_normal((3, hbo + 2, inner.WC, inner.L)), jnp.bfloat16)
    kp, kp_j = _pair(rng.standard_normal((3, 3, inner.L, inner.NO)) * 0.05, jnp.bfloat16)
    ku, ku_j = _pair(rng.standard_normal((3, 3, inner.C4, inner.C4)) * 0.05, jnp.bfloat16)
    kd, kd_j = _pair(rng.standard_normal((3, 3, inner.C4, inner.C4)) * 0.05, jnp.bfloat16)
    want = np.asarray(_inner_jax(inner, "dots27", hbo, z_j, kp_j, ku_j, kd_j), np.float32)
    return (z, kp, ku, kd), want


@pytest.mark.parametrize("hbo", [1, 2, 3, 4])
@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
def test_inner_step_planned_matches_jax(strategy, hbo):
    """The kernel's walk (slabs or per-tap items as its loads give them, the
    dw shifts, the packed tiles unswizzled, the column halves) on tiles of
    192 rows, the last one ragged (hbo * WC = 136, 272, 408 or 544 rows),
    held to the TPU probe's dots27 on every row, edge rows included."""
    (z, kp, ku, kd), want = _inner_case(hbo)
    assert (hbo * inner_probe.WC) % inner_probe.TILE_ROWS
    got = inner_probe.inner_step_planned(z, kp, ku, kd, hbo, strategy)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _err(got, want) <= BF16_TOL
    assert _err(got[:, [0, -1]], want[:, [0, -1]]) <= BF16_TOL


@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
def test_inner_packing_unpacks_to_the_weights(strategy):
    """Each step's packed tile, unswizzled, is the weights of its tap and
    chunk (kext: the 128 columns of [kp; blockdiag(ku, kd)], zero blocks
    included); the tiles cover the packed weights exactly, in order."""
    rng = np.random.default_rng(7)
    kp = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32)).bfloat16()
    ku, kd = (torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32)).bfloat16()
              for _ in range(2))
    packed = inner_probe.pack_inner_weights(kp, ku, kd, strategy)
    ke = inner_probe.pack_weights(kp, ku, kd).view(3, 3, 256, 128)
    assert packed.shape == (inner_probe.weight_elems(strategy),)
    end = 0
    for st in inner_probe.inner_steps(strategy):
        assert st.woff == end
        end = st.woff + st.width * inner_probe.K_TILE
        tile = inner_probe.swizzle_rows(packed[st.woff:end].view(st.width, 64)).t()  # (K, cols)
        k0 = {1: st.lane0, 0: 128, 2: 192}[st.plane]
        full = ke[st.dh + 1, st.dw + 1, k0:k0 + 64]
        want = {inner_probe.ALL: full, inner_probe.LOW: full[:, :64],
                inner_probe.HIGH: full[:, 64:]}[st.cols]
        assert torch.equal(tile, want), st
    assert end == packed.numel()


@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
def test_inner_plan_walks_every_tap_once(strategy):
    """Every (dh, dw, chunk) once; the first step adds to every column (it
    starts the sum); dots27 and bext_s multiply a neighbour chunk's non-zero
    block only, kext every column; bext_s stages an aligned item a step,
    the others one slab per (dh, chunk) read at shifts 0, 1, 2; the C
    plan's tables say the same."""
    steps = inner_probe.inner_steps(strategy)
    assert sorted((st.dh, st.dw, st.chunk) for st in steps) == sorted(
        (dh, dw, name) for dh in (-1, 0, 1) for dw in (-1, 0, 1)
        for name, _, _ in inner_probe.CHUNKS)
    assert steps[0].cols == inner_probe.ALL and steps[0].new_item
    per_tap = strategy == "bext_s"
    for st in steps:
        assert st.cols == (inner_probe.ALL if st.plane == 1 or strategy == "kext"
                           else inner_probe.LOW if st.plane == 0 else inner_probe.HIGH)
        assert st.new_item == (per_tap or st.dw == -1)
        assert (st.row, st.shift) == ((st.dw, 0) if per_tap else (-1, st.dw + 1))
    ints = list(inner_probe.plan_ints(strategy, 136))
    items = [i for i, st in enumerate(steps) if st.new_item]
    head, tables = ints[:inner_probe.PLAN_HEADER], ints[inner_probe.PLAN_HEADER:]
    assert head == [36, len(items), inner_probe.weight_elems(strategy)]
    flags, rows, woffs, item_step = (tables[i * 36:(i + 1) * 36] for i in range(4))
    assert item_step[:len(items)] == items
    for i, st in enumerate(steps):
        assert flags[i] == (st.new_item | st.plane << 1 | (st.lane0 // 64) << 3 | st.cols << 4
                            | st.shift << 6)
        assert rows[i] == (1 + st.dh) * 136 + st.row and woffs[i] == st.woff


def test_inner_yardstick_is_the_function_but_at_the_wrap_columns():
    """``F.conv3d`` on z's channels_last_3d view with the stacked weights
    equals the plain dots27 function in f32 on every column but the first
    and last of each row of WC, where it reads zeros and the function the
    neighbouring row's end."""
    rng = np.random.default_rng(8)
    hbo, wc = 3, inner_probe.WC
    z = torch.from_numpy(rng.standard_normal((2, 3, hbo + 2, wc, 128)).astype(np.float32))
    kp = torch.from_numpy(rng.standard_normal((3, 3, 128, 128)).astype(np.float32) * 0.05)
    ku, kd = (torch.from_numpy(rng.standard_normal((3, 3, 64, 64)).astype(np.float32) * 0.05)
              for _ in range(2))
    want = inner_probe.inner_step_reference(z, kp, ku, kd, hbo).view(2, hbo, wc, 128)
    y = inner_probe.library_conv(z, inner_probe.library_weight(kp, ku, kd))
    assert y.shape == (2, 128, 1, hbo, wc)
    got = y[:, :, 0].permute(0, 2, 3, 1)                       # (B, hbo, WC, NO)
    assert _err(got[:, :, 1:-1], want[:, :, 1:-1]) <= F32_TOL
    assert _err(got[:, :, [0, -1]], want[:, :, [0, -1]]) > 1e-2


def _inner_wrapper_case(change):
    z, kp, ku, kd = inner_probe.inputs(1, 2, "cpu")
    packed = inner_probe.pack_inner_weights(kp, ku, kd, "dots27")
    return change(z, packed)


@pytest.mark.parametrize("change,error", [
    (lambda z, w: (z.float(), w, 2, "dots27"), TypeError),
    (lambda z, w: (z, w, 3, "dots27"), ValueError),                        # hbo + 2 != 4
    (lambda z, w: (z, w, 2, "dots9"), ValueError),
    (lambda z, w: (z, w, 2, "kext"), ValueError),                          # dots27's packing
    (lambda z, w: (z[..., :64].contiguous(), w, 2, "dots27"), ValueError),  # L 64
    (lambda z, w: (z.transpose(-1, -2).contiguous().transpose(-1, -2), w, 2, "dots27"),
     ValueError),                                                         # not contiguous
    (lambda z, w: (torch.empty(z.numel() + 1, dtype=z.dtype)[1:].view(z.shape), w, 2, "dots27"),
     ValueError),                                                         # 2 bytes off 16
    (lambda z, w: (z[0, :2], w, 2, "dots27"), ValueError),                 # not 3 planes
])
def test_inner_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    """The checks ahead of every ``inner_taps`` launch, on the CPU."""
    with pytest.raises(error):
        inner_probe.check_inner(*_inner_wrapper_case(change))


def test_inner_wrapper_takes_the_probe_and_wants_the_card():
    z, packed, hbo, strategy = _inner_wrapper_case(lambda z, w: (z, w, 2, "dots27"))
    assert inner_probe.check_inner(z, packed, hbo, strategy).shape == (1, 3, 4, 136, 128)
    with pytest.raises(ValueError):     # CPU tensors never reach the kernel
        inner_probe.inner_step_packed(z, packed, hbo, strategy)


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


# ---- #8 and #10: taps_fold's fold (dot_probe.fold_taps_reference) ----------

def _folded_sum(x, w, offsets, m):
    """sum over distinct offsets of x[off] @ hi + x[off] @ lo, in f32: what
    ``taps_fold`` computes before its final rounding."""
    distinct, hi, lo = dot_probe.fold_taps_reference(w, offsets)
    acc = torch.zeros((x.shape[0], m, w.shape[2]))
    for d, off in enumerate(distinct):
        rows = dot_probe.shifted_rows(x, off, m).float()
        acc = acc + rows @ hi[d].float() + rows @ lo[d].float()
    return acc


@pytest.mark.parametrize("variant", sorted(rowoffset_probe.OFFSETS))
def test_fold_taps_matches_jax_rowoffset(rowoffset, variant):
    """#8: the folded sum of bf16-valued inputs against the TPU probe's 9
    dots in f32 (its pallas_call in interpret mode)."""
    offsets = rowoffset_probe.OFFSETS[variant]
    rng = np.random.default_rng(3)
    x, x_j = _pair(rng.standard_normal((2, rowoffset.M_PAD, rowoffset.K)), jnp.bfloat16)
    w, w_j = _pair(rng.standard_normal((9, rowoffset.K, rowoffset.N)) * 0.05, jnp.bfloat16)
    want = _rowoffset_jax(rowoffset, offsets, x_j.astype(jnp.float32), w_j.astype(jnp.float32))
    got = _folded_sum(x, w, offsets, rowoffset.M)
    assert _err(got, want) <= F32_TOL


@pytest.mark.parametrize("name,taps,k,n,acc", [v for v in dot_probe.VARIANTS
                                               if v[4] == torch.float32])
def test_fold_taps_matches_jax_dot(name, taps, k, n, acc):
    """#10: the folded sum of bf16-valued inputs against ``bench``'s taps
    summed in f32 (``_dot_jax``)."""
    rng = np.random.default_rng(9)
    x, x_j = _pair(rng.standard_normal((2, 64, k)), jnp.bfloat16)
    w, w_j = _pair(rng.standard_normal((taps, k, n)) * 0.05, jnp.bfloat16)
    want = _dot_jax(x_j.astype(jnp.float32), w_j.astype(jnp.float32), jnp.float32)
    got = _folded_sum(x, w, [0] * taps, 64)
    assert _err(got, want) <= F32_TOL


def test_fold_taps_splits_only_shared_offsets():
    """A lone tap keeps its weight (lo 0); taps that share an offset fold to
    hi + lo, which rounds back to the f32 sum's bf16 value and holds it to
    2^-16 of each sum."""
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((4, 16, 16)).astype(np.float32)).bfloat16()
    distinct, hi, lo = dot_probe.fold_taps_reference(w, [5, 0, 5, 7])
    assert distinct == [5, 0, 7]
    assert torch.equal(hi[1], w[1]) and torch.equal(hi[2], w[3])
    assert not lo[1].any() and not lo[2].any()
    s = w[0].float() + w[2].float()
    assert torch.equal(hi[0], s.bfloat16())
    assert ((hi[0].float() + lo[0].float() - s).abs() <= s.abs() * 2.0 ** -16).all()


# what each probe shape's plan must be: (k, n, offsets, bf16 acc) -> (column
# tile, mode, products); every one keeps its folded weights resident
PROBE_PLANS = [
    ((128, 64, (0,) * 9, False), (64, dot_probe.FOLD, 2)),           # #10 A
    ((128, 128, (0,) * 9, False), (128, dot_probe.FOLD, 2)),         # #10 B
    ((1152, 64, (0,), False), (64, dot_probe.FOLD, 1)),              # #10 C
    ((1152, 128, (0,), False), (64, dot_probe.FOLD, 1)),             # #10 D: two column tiles
    ((128, 64, (0,) * 9, True), (64, dot_probe.WHOLE, 9)),           # #10 E
    ((128, 128, (0,) * 27, False), (128, dot_probe.FOLD, 2)),        # #10 F
    ((128, 64, tuple(rowoffset_probe.OFFSETS["B. 9 dots, aligned offsets (k*576)"]), False),
     (64, dot_probe.FOLD, 6)),
    ((128, 64, tuple(rowoffset_probe.OFFSETS["C. 9 dots, misaligned offsets (k*577)"]), False),
     (64, dot_probe.FOLD, 6)),
    ((27 * 64, 32, (0,), False), (32, dot_probe.FOLD, 1)),           # tap-folded conv K
]


@pytest.mark.parametrize("signature,want", PROBE_PLANS)
def test_tap_plan_keeps_probe_weights_resident(signature, want):
    plan = dot_probe.tap_plan(*signature)
    assert (plan.nt, plan.mode, len(plan.products)) == want
    assert not plan.streamed and plan.smem <= dot_probe.TAP_SMEM


def test_tap_plan_tables():
    """The C plan: header, then each distinct offset's rows and products,
    each product's offset, part and taps, and the fold groups (a hi and lo
    pair is one); bf16 accumulation keeps tap order in runs of one
    offset."""
    plan = dot_probe.tap_plan(128, 64, (0, 577, 1154) * 3, False)
    ints = list(plan.ints)
    assert ints[:16] == [128, 64, 64, 2, 1, dot_probe.FOLD, 0, 4, 1, 6, 3, 6, 133120, 98304, 0,
                         3]
    table = ints[dot_probe.PLAN_HEADER:]
    assert table[:3] == [0, 577, 1154] and table[32:35] == [0, 2, 4] and table[64:67] == [2, 2, 2]
    assert table[128:134] == [dot_probe.HI, dot_probe.LO] * 3
    assert table[224:233] == [0, 3, 6, 1, 4, 7, 2, 5, 8]
    assert table[256:259] == [0, 2, 4]  # each fold group's first product
    runs = dot_probe.tap_plan(128, 64, (0, 577, 1154) * 3, True)
    assert runs.offsets == (0, 577, 1154) * 3 and runs.mode == dot_probe.WHOLE
    assert [p[2] for p in runs.products] == [(t,) for t in range(9)]
    big = dot_probe.tap_plan(2048, 128, tuple(range(32)), False)
    assert big.streamed and big.nt == 128


@pytest.mark.parametrize("bf16_acc", [False, True])
@pytest.mark.parametrize("k,n", [(2048, 128), (1152, 64), (2048, 16)])
def test_tap_plan_streamed_ring_outlasts_its_readers(k, n, bf16_acc):
    """Where the folded weights stream, their ring has two slots (of two
    tiles) more than A's ring: the copy issued at step s fills the slot that
    step s - 3 read, whose products every warpgroup has waited for
    (``csrc/probe_taps.cu``). The ring, the running sums and the weights fit
    below the barriers."""
    plan = dot_probe.tap_plan(k, n, tuple(range(32)), bf16_acc)
    ints = list(plan.ints)
    w_offset, w_bytes, ring = ints[12], ints[13], ints[16]
    assert plan.streamed and plan.slots in (2, 3) and plan.nsub == 1
    assert w_bytes == (plan.slots + 2) * 2 * plan.nt * dot_probe.K_TILE * 2
    sums = plan.nt * dot_probe.THREADS if bf16_acc else 0
    assert ring == plan.slots * dot_probe.A_TILE_BYTES and ring + sums <= w_offset
    assert w_offset % 1024 == 0 and w_offset + w_bytes <= dot_probe.TAP_SMEM
    assert plan.smem == ring + sums + w_bytes


@pytest.mark.parametrize("offsets", [[-400, 0, 3], [2, 301, -5], [-301, 300]])
def test_tap_sum_reads_zeros_wholly_outside(offsets):
    """A tap whose rows lie wholly before 0 or past R reads only zeros."""
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.standard_normal((1, 300, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((len(offsets), 8, 16)).astype(np.float32))
    got = dot_probe.tap_sum(x, w, offsets=offsets, m=300)
    padded = torch.nn.functional.pad(x, (0, 0, 700, 700))
    want = sum(padded[:, 700 + o:1000 + o] @ w[t] for t, o in enumerate(offsets))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", sorted(rowoffset_probe.OFFSETS))
def test_row_offset_library_call_matches_plain(variant):
    """The library yardstick of #8 (einsum, or F.conv1d with dilation on the
    folded taps) computes the probe's function: f32 inputs, so the fold
    rounds only the folded weights to the inputs' dtype (f32 here)."""
    offsets = [o // 64 for o in rowoffset_probe.OFFSETS[variant]]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 200, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((9, 16, 8)).astype(np.float32) * 0.05)
    got = rowoffset_probe.library_call(x, w, offsets, 160)()
    want = rowoffset_probe.row_offset_sum_reference(x, w, offsets, 160)
    assert got.shape == want.shape
    assert _err(got, want.numpy()) <= F32_TOL
