"""The port's CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU and ``nvcc``; skips without a card. On a machine with
the card and no jax (this file imports none), run it without the repo's
jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances, each a share of the plain output's largest magnitude:

* linear attention: f32 5e-5 (sums in another order); bf16 2e-2 (both
  round their f32 result to bf16 once, at places that can differ by one
  bf16 ulp). Its backward: dq, dk and dv each within 1e-5 (f32) and 2e-2
  (bf16) of their own max |plain|, for the same reasons; a gradient that is
  zero in exact arithmetic (dk of a single token, whose token softmax is 1;
  below 1e-3 of the largest of the three) is held against a tenth of the
  largest instead, the scale of the two sums that cancel in it.
* conv unit: y and z f32 1e-5, bf16 2e-2 (the same operands, rounded alike,
  summed in f32 in another order; bf16 outputs one ulp apart); statistics
  f32 1e-5, bf16 1e-3 (sums of outputs that can sit one bf16 ulp apart).
* transformer stack: f32 1e-5 (f32 through post-LN layers, sums in another
  order); bf16 3e-2 (the kernel rounds every product's operands to bf16, as
  the TPU kernel does; the plain version computes in f32 and rounds the
  tokens once a layer).
* probes (``lintransunet_tpu_torch/experiments``): bf16 2e-2 (the same bf16
  operands, products summed in f32 in another order, each side rounding
  its result to bf16 once); variant E's bf16 accumulation 3e-2 (a bf16
  rounding after every tap, where a one-ulp difference carries into the
  next sum); f32 convs 1e-5 (f32 FMA against cuDNN in f32 with TF32 off);
  lane sums 1e-5 of each sum's max |plain| (f32 sums in another order).
"""

import pytest
import torch

from lintransunet_tpu_torch.experiments import (
    conv_prototype,
    conv_retired,
    dot_probe,
    in_stats_probe,
    inner_probe,
    rowoffset_probe,
)
from lintransunet_tpu_torch.ops import conv_unit as cu
from lintransunet_tpu_torch.ops import fused_stack as fs
from lintransunet_tpu_torch.ops import linear_attention as fused

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype) for _ in range(3)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(1, 8, 4096, 32), (1, 4, 28704, 32),
                                   (2, 3, 300, 32), (1, 2, 1, 32),
                                   (1, 2, 129, 16)])
def test_kernel_matches_plain(cuda, shape, dtype, tol):
    q, k, v = _qkv(shape, dtype, cuda)
    before = fused.linear_attention.launches
    got = fused.linear_attention(q, k, v)
    torch.cuda.synchronize()
    assert fused.linear_attention.launches == before + 1
    want = fused.linear_attention_reference(q, k, v)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def test_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(TypeError):
        fused.linear_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        fused.linear_attention(q[:, :, ::2], k[:, :, ::2], v[:, :, ::2])
    wide = _qkv((1, 1, 64, 64), torch.float32, cuda)
    with pytest.raises(ValueError):
        fused.linear_attention(*wide)
    with pytest.raises(ValueError):
        fused.linear_attention_backward(q, k, v, q[:, :, :32].contiguous())


BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 8, 2048, 32), (1, 4, 14352, 32),
                                   (2, 3, 300, 32), (1, 2, 1, 32),
                                   (1, 2, 129, 16)])
def test_backward_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    g = _qkv(shape, dtype, cuda, seed=1)[0]
    before = fused.linear_attention_backward.launches
    got = fused.linear_attention_backward(q, k, v, g)
    torch.cuda.synchronize()
    assert fused.linear_attention_backward.launches == before + 1
    want = fused.linear_attention_backward_reference(q, k, v, g)
    top = max(w.float().abs().max().item() for w in want)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        scale = b.float().abs().max().item()
        assert err <= BWD_TOL[dtype] * (scale if scale >= 1e-3 * top else 1e-1 * top)


def test_autograd_launches_both_kernels(cuda):
    q, k, v = (t.requires_grad_() for t in _qkv((1, 4, 777, 32), torch.float32, cuda))
    g = _qkv((1, 4, 777, 32), torch.float32, cuda, seed=1)[0]
    before = (fused.linear_attention.launches, fused.linear_attention_backward.launches)
    out = fused.linear_attention(q, k, v)
    out.backward(g.transpose(1, 2).contiguous().transpose(1, 2))  # a strided gradient
    assert (fused.linear_attention.launches,
            fused.linear_attention_backward.launches) == (before[0] + 1, before[1] + 1)
    want = fused.linear_attention_backward_reference(q.detach(), k.detach(), v.detach(), g)
    for t, w in zip((q, k, v), want):
        assert _rel(t.grad, w) <= BWD_TOL[torch.float32]


def _rel(got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err / max(want.float().abs().max().item(), 1e-30)


def _conv_inputs(n, ca, cb, o, spatial, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    w = (rnd(o, ca + cb, 3, 3, 3) / (27 * (ca + cb)) ** 0.5).to(device)
    kw = dict(bias=(rnd(o) * 0.1).to(device),
              affine_a=torch.stack([rnd(n, ca).abs() + 0.5, rnd(n, ca)], 1).to(device))
    if cb:
        kw.update(xb=rnd(n, cb, *spatial).to(device, dtype), wb=w[:, ca:])
    return rnd(n, ca, *spatial).to(device, dtype), w[:, :ca], kw


CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 1e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,ca,cb,o,spatial", [
    (1, 32, 32, 32, (128, 128, 64)),   # the level-1 UpBlock's conv2
    (1, 4, 0, 16, (256, 256, 64)),     # the input block
    (2, 5, 0, 7, (9, 7, 13)),          # ragged in every dim
    (1, 3, 6, 20, (6, 5, 70)),         # ragged, dual, two output tiles
    (2, 20, 0, 16, (17, 11, 70)),      # ragged in every dim of the 4 x 4 x 32 tile
    (1, 16, 16, 16, (256, 256, 64)),   # the level-0 UpBlock's conv2: dual, NT = 16
    (1, 64, 0, 32, (128, 128, 64)),    # the level-1 UpBlock's conv1
    (1, 8, 8, 24, (9, 10, 1)),         # D = 1
    (1, 40, 0, 40, (8, 6, 16)),        # two output tiles of 32 channels
    (1, 160, 160, 32, (6, 7, 40)),     # weights too large to stay in shared memory
])
def test_conv_unit_matches_plain(cuda, dtype, n, ca, cb, o, spatial):
    xa, wa, kw = _conv_inputs(n, ca, cb, o, spatial, dtype, cuda)
    kw["compute_dtype"] = dtype
    before = cu.conv_unit.launches
    got = cu.conv_unit(xa, wa, want_z=True, **kw)
    torch.cuda.synchronize()
    assert cu.conv_unit.launches == before + 1
    want = cu.conv_unit_reference(xa, wa, want_z=True, **kw)
    y_tol, stats_tol = CONV_TOL[dtype]
    assert got[0].dtype == dtype and got[0].shape == (n, o) + spatial
    assert got[2].shape == xa.shape
    assert _rel(got[0], want[0]) <= y_tol
    assert _rel(got[1], want[1]) <= stats_tol
    assert _rel(got[2], want[2]) <= y_tol


@pytest.mark.parametrize("n,ca,cb,o,spatial", [
    (1, 32, 32, 32, (128, 128, 64)),
    (2, 5, 0, 7, (9, 7, 13)),
    (2, 20, 0, 16, (17, 11, 70)),
    (1, 8, 8, 24, (9, 10, 1)),
])
def test_conv_unit_f32_input_bf16_operands(cuda, n, ca, cb, o, spatial):
    """The default: f32 activations, operands rounded to bf16 when staged,
    y and z in f32; held to the f32 tolerance against the plain version,
    which rounds the same operands."""
    xa, wa, kw = _conv_inputs(n, ca, cb, o, spatial, torch.float32, cuda)
    got = cu.conv_unit(xa, wa, want_z=True, **kw)
    want = cu.conv_unit_reference(xa, wa, want_z=True, **kw)
    assert got[0].dtype == torch.float32
    y_tol, stats_tol = CONV_TOL[torch.float32]
    assert _rel(got[0], want[0]) <= y_tol
    assert _rel(got[1], want[1]) <= stats_tol
    assert _rel(got[2], want[2]) <= y_tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_unit_is_deterministic(cuda, dtype):
    """Two calls give the same bits: y, z and the statistics (per-block
    partials of a persistent grid, added in a fixed order, no atomics)."""
    xa, wa, kw = _conv_inputs(1, 16, 16, 16, (64, 64, 64), dtype, cuda)
    first = cu.conv_unit(xa, wa, want_z=True, **kw)
    second = cu.conv_unit(xa, wa, want_z=True, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _stack_inputs(b, n, c, layers, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    A = rnd(layers, c, 6 * c) / c ** 0.5
    w2 = rnd(layers, 2 * c, c) / (2 * c) ** 0.5
    vecs = rnd(layers, 16, 2 * c) * 0.1
    vecs[:, 6] += 1.0   # LayerNorm scales near 1
    vecs[:, 8] += 1.0
    x = rnd(b, n, c).to(device, dtype)
    return x, A.to(device), w2.to(device), vecs.to(device)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,n,c,layers", [
    (1, 5376, 256, 2),     # the level-2 ROI stack's width and tokens
    (1, 28704, 128, 1),    # the level-1 ROI stack
    (2, 300, 128, 2),      # ragged N, batch 2
    (1, 1, 64, 1),         # one token
])
def test_fused_stack_matches_plain(cuda, dtype, tol, b, n, c, layers):
    x, A, w2, vecs = _stack_inputs(b, n, c, layers, dtype, cuda)
    before = fs.fused_transformer_stack.launches
    got = fs.fused_transformer_stack(x, A, w2, vecs, c // 32)
    torch.cuda.synchronize()
    assert fs.fused_transformer_stack.launches == before + 1
    want = fs.fused_transformer_stack_reference(x, A, w2, vecs, c // 32)
    assert got.dtype == dtype and got.shape == x.shape
    assert _rel(got, want) <= tol


def test_new_kernels_reject_what_they_do_not_take(cuda):
    xa, wa, kw = _conv_inputs(1, 4, 0, 8, (8, 8, 8), torch.float32, cuda)
    with pytest.raises(TypeError):
        cu.conv_unit(xa.half(), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa.transpose(2, 3), wa)
    with pytest.raises(ValueError):
        cu.conv_unit(xa, wa, compute_dtype=torch.float16)
    with pytest.raises(NotImplementedError):
        cu.conv_unit(xa, wa.clone().requires_grad_())
    x, A, w2, vecs = _stack_inputs(1, 64, 128, 1, torch.float32, cuda)
    with pytest.raises(TypeError):
        fs.fused_transformer_stack(x.half(), A, w2, vecs, 4)
    with pytest.raises(ValueError):
        fs.fused_transformer_stack(x[:, ::2], A, w2, vecs, 4)
    with pytest.raises(ValueError):
        fs.fused_transformer_stack(x, A, w2, vecs, 2)  # d_k 64
    with pytest.raises(NotImplementedError):
        fs.fused_transformer_stack(x.requires_grad_(), A, w2, vecs, 4)


def test_small_train_step_kernel_matches_plain(cuda):
    """One train step of a small MaskTransUnet in f32 (TF32 off), kernel vs
    plain attention: 8 forward and 8 backward kernel launches (4 bridges of
    2 layers), the loss within 1e-5 relative and the gradients within 1e-3
    of their max |plain| (a gradient that vanishes in exact arithmetic is
    held against a tenth of the largest, as in ``chip_smoke.py``)."""
    from lintransunet_tpu_torch import engine
    from lintransunet_tpu_torch.cli.common import get_criterion_list
    from lintransunet_tpu_torch.models import MaskTransUnet, init_random_

    small = dict(num_layers=(8, 16, 32, 32, 64), roi_size_list=(16, 12, 8, 6, 4),
                 is_roi_list=(False, True, True, True, True), dim_input=1,
                 dim_output=2, n_layers=2, dropout=0.3)
    g = torch.Generator(device="cpu").manual_seed(0)
    images = torch.randn((1, 1, 64, 64, 8), generator=g).to(cuda)
    labels = torch.zeros((1, 64, 64, 8), dtype=torch.long, device=cuda)
    labels[:, 20:44, 24:40, 2:6] = 1
    criterions, _ = get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    results = {}
    for impl in ("kernel", "plain"):
        model = MaskTransUnet(**small, attention_impl=impl, device=cuda)
        init_random_(model, torch.Generator(device="cpu").manual_seed(1))
        state = engine.create_train_state(model, 1e-4)
        before = (fused.linear_attention.launches, fused.linear_attention_backward.launches)
        loss, _ = engine.make_train_step(model, criterions)(
            state, images, labels, [0.1, 0.2, 0.3, 0.4, 1.0],
            torch.Generator(device=cuda).manual_seed(2))
        launched = (fused.linear_attention.launches - before[0],
                    fused.linear_attention_backward.launches - before[1])
        results[impl] = (loss.item(), {n: p.grad for n, p in model.named_parameters()},
                         launched)
    assert results["kernel"][2] == (8, 8) and results["plain"][2] == (0, 0)
    (loss, grads, _), (want_loss, want, _) = results["kernel"], results["plain"]
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    top = max(w.abs().max().item() for w in want.values())
    for name, w in want.items():
        scale = w.abs().max().item()
        scale = scale if scale >= 1e-5 * top else 1e-1 * top
        assert (grads[name] - w).abs().max().item() <= 1e-3 * scale, name


PROBE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _probe_taps(groups, rows, k, taps, n, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((groups, rows, k), generator=g).to(device, torch.bfloat16)
    w = (torch.randn((taps, k, n), generator=g) * 0.05).to(device, torch.bfloat16)
    return x, w


@pytest.mark.parametrize("taps,k,n,acc,staging", [
    (9, 128, 64, torch.float32, "window"),      # variant A
    (9, 128, 64, torch.float32, "per_tap"),
    (9, 128, 128, torch.float32, "im2col"),     # variant B's shape
    (1, 1152, 64, torch.float32, "window"),     # variant C
    (9, 128, 64, torch.bfloat16, "per_tap"),    # variant E
    (27, 128, 128, torch.float32, "window"),    # variant F
    (27, 16, 16, torch.float32, "window"),      # the conv unit's smallest taps
    (1, 27 * 32, 32, torch.float32, "window"),  # tap-folded K = 27 C_in
])
def test_tap_sum_matches_plain(cuda, taps, k, n, acc, staging):
    x, w = _probe_taps(3, 4096 + 77, k, taps, n, cuda)
    before = dot_probe.tap_sum.launches
    got = dot_probe.tap_sum(x, w, acc_dtype=acc, staging=staging)
    torch.cuda.synchronize()
    assert dot_probe.tap_sum.launches == before + 1
    want = dot_probe.tap_sum_reference(x, w, acc_dtype=acc)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert _rel(got, want) <= (1e-2 if acc == torch.bfloat16 else 2e-2)
    if acc == torch.bfloat16:  # nearer the bf16-accumulated sum than the f32 one
        f32_acc = dot_probe.tap_sum_reference(x, w)
        assert dot_probe.bf16_rounding_share(got, want, f32_acc) <= dot_probe.E_ROUNDING_SHARE


@pytest.mark.parametrize("staging", ["window", "per_tap"])
@pytest.mark.parametrize("variant", sorted(rowoffset_probe.OFFSETS))
def test_row_offset_sum_matches_plain(cuda, variant, staging):
    x, w = rowoffset_probe.inputs(2, rowoffset_probe.M_PAD, cuda)
    offsets = rowoffset_probe.OFFSETS[variant]
    before = rowoffset_probe.row_offset_sum.launches
    got = rowoffset_probe.row_offset_sum(x, w, offsets, staging=staging)
    torch.cuda.synchronize()
    assert rowoffset_probe.row_offset_sum.launches == before + 1
    want = rowoffset_probe.row_offset_sum_reference(x, w, offsets)
    assert got.shape == (2, rowoffset_probe.M, rowoffset_probe.N)
    assert _rel(got, want) <= PROBE_TOL[torch.bfloat16]


@pytest.mark.parametrize("strategy", inner_probe.STRATEGIES)
@pytest.mark.parametrize("batch,hbo", [(3, 12), (1, 2)])
def test_inner_step_matches_plain(cuda, strategy, batch, hbo):
    """Every strategy is held to the dots27 function on all rows, the two
    clipped edge rows included."""
    z, kp, ku, kd = inner_probe.inputs(batch, hbo, cuda)
    ke = inner_probe.pack_weights(kp, ku, kd)
    before = inner_probe.inner_step_packed.launches
    got = inner_probe.inner_step_packed(z, ke, hbo, strategy)
    torch.cuda.synchronize()
    assert inner_probe.inner_step_packed.launches == before + 1
    want = inner_probe.inner_step_reference(z, kp, ku, kd, hbo)
    assert got.shape == (batch, hbo * inner_probe.WC, inner_probe.NO)
    assert _rel(got, want) <= PROBE_TOL[torch.bfloat16]
    assert _rel(got[:, [0, -1]], want[:, [0, -1]]) <= PROBE_TOL[torch.bfloat16]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_out", [
    ((32, 16, 64, 64), 64),     # the TPU probe's C and D
    ((8, 12, 32, 32), 128),     # D 32: a 1 x 4 x 32 tile, 128 outputs
])
def test_conv3d_cl_matches_plain(cuda, dtype, shape, n_out):
    x, k = conv_prototype.inputs(shape, n_out, cuda, dtype)
    before = conv_prototype.conv3d_cl.launches
    got = conv_prototype.conv3d_cl(x, k)
    torch.cuda.synchronize()
    assert conv_prototype.conv3d_cl.launches == before + 1
    want = conv_prototype.conv3d_cl_reference(x, k)
    assert got.dtype == dtype and got.shape == shape[:3] + (n_out,)
    assert _rel(got, want) <= PROBE_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,n_out,tile", [
    ((2, 16, 8, 64, 64), 64, None),     # the level-0 packed C4 = O4 = 64
    ((1, 8, 8, 64, 128), 128, None),    # the 8C-lane C4 = O4 = 128
    ((1, 6, 8, 32, 32), 64, (2, 2)),
])
def test_conv3d_cl_rows_matches_plain(cuda, dtype, shape, n_out, tile):
    xp, k, bias = conv_retired.inputs(shape, n_out, cuda, dtype)
    th, tw = tile or (None, None)
    before = conv_retired.conv3d_cl_rows.launches
    got = conv_retired.conv3d_cl_rows(xp, k, bias, th, tw)
    torch.cuda.synchronize()
    assert conv_retired.conv3d_cl_rows.launches == before + 1
    want = conv_retired.conv3d_cl_rows_reference(xp, k, bias)
    assert got.dtype == dtype and got.shape == shape[:4] + (n_out,)
    assert _rel(got, want) <= PROBE_TOL[dtype]


@pytest.mark.parametrize("shape,scale", [((4, 16, 8, 256), 1.0), ((2, 24, 16, 128), 0.7),
                                         ((32, 128, 128, 128), 1.0)])
def test_lane_sums_matches_plain(cuda, shape, scale):
    x = in_stats_probe.inputs(shape, cuda)
    before = in_stats_probe.lane_sums.launches
    got = in_stats_probe.lane_sums(x, scale)
    torch.cuda.synchronize()
    assert in_stats_probe.lane_sums.launches == before + 1
    want = in_stats_probe.lane_sums_reference(x, scale)
    assert got.shape == want.shape and got.dtype == torch.float32
    for part in (0, 1):
        assert _rel(got[:, :, part], want[:, :, part]) <= 1e-5


def test_probes_reject_what_they_do_not_take(cuda):
    x, w = _probe_taps(1, 256, 128, 9, 64, cuda)
    with pytest.raises(TypeError):
        dot_probe.tap_sum(x.float(), w.float())
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x[:, ::2], w)
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w[:8], staging="im2col")
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w, acc_dtype=torch.bfloat16)        # needs per_tap
    with pytest.raises(ValueError):
        dot_probe.tap_sum(x, w, offsets=[0] * 8 + [4000])         # window too large
    xc, k = conv_prototype.inputs((8, 8, 64, 64), 64, cuda)
    with pytest.raises(ValueError):
        conv_retired.conv3d_cl_rows(xc[None], k, None, 1, 1)      # th * tw * D != 128
    with pytest.raises(TypeError):
        conv_prototype.conv3d_cl(xc, k.float())
    with pytest.raises(TypeError):
        in_stats_probe.lane_sums(xc.float())
