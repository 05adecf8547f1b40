"""The port's self-attention projection, one product for q, k and v (the
JAX package's ``LINTRANSUNET_FUSED_QKV=1`` formulation, which the port always
takes), against the JAX package with ``blocks.FUSED_QKV`` monkeypatched on
(as ``tests/test_models.py:196`` does) and against the three products of
JAX's default path (``_three_products``, patched in for
``MultiheadLinearAttention.forward``), in f32 on the CPU.

A self-attention layer projects q, k and v in one product with the three
weights concatenated at call time, and the attention takes the three thirds
of that (B, N, 3*C) product in place
(``ops.linear_attention.linear_attention_qkv``, whose backward gives the
product's gradient whole). The state_dict is that of three projections.

* A TINY ``MaskTransUnet`` (``tests/test_models.py:188``'s widths, two
  attention layers a bridge) in eval: the probabilities and masks against
  JAX's with the flag on (atol 5e-5: every layer's f32 sums in another
  order; port against JAX measured 1.2e-5 to 1.3e-5 here with the flag on
  and off alike, ``tests/test_torch_model.py`` holds SMALL to 1e-4) and
  against the three products (rtol 1e-5, atol 1e-6: the same contractions,
  one GEMM instead of three; equal to the bit here); every attention layer
  took the fused route.
* One SMALL train step (``tests/test_torch_train.py``'s seed 11, dropout 0):
  the loss within 1e-5 relative and every gradient within 1e-4 of its max
  (that file's rule) of JAX's ``value_and_grad`` with the flag on, and of
  the port's step with the three products.
* The plain path's backward in the packed layout: the gradient of the
  (B, N, 3*H*d) projection against ``jax.vjp`` of JAX's attention on its
  split (rtol 1e-5, atol 1e-6), and ``linear_attention_backward`` writing
  into the thirds of one buffer gives the same values.
* The masked path (``TransEncoder`` with a mask) against JAX with the flag
  on (atol 1e-5), and the "attn" recompute: the loss, output and gradients
  bit for bit those without recompute, the recompute through the fused
  route again.
* The fused eval configuration (``fused_stack``, which has its own QKV)
  gives the same bits whichever projection the module runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import engine as jax_engine
from lintransunet_tpu import ops as jax_ops
from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu.models import blocks as jax_blocks
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.compat import from_flax, from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.models import MaskTransUnet, TransEncoder, blocks, init_random_
from lintransunet_tpu_torch.ops import attention
from lintransunet_tpu_torch.ops import linear_attention as fused
from torch_port_helpers import SMALL, load_port, random_params, t, worst_grad_error

torch.set_num_threads(2)

TINY = dict(num_layers=(8, 16, 32), roi_size_list=(6, 6, 4),
            is_roi_list=(True, True, True), dim_input=1, dim_output=2, n_layers=2)
TINY_SEED = 2
STEP_SEED = 11  # tests/test_torch_train.py: clear of the box threshold
PATCH = (1, 64, 64, 8)
CRITERIA = ["CrossEntroLoss", "DiceClassLoss"]


def _qkv_calls(monkeypatch):
    """A list that grows by one at each ``linear_attention_qkv`` call."""
    calls = []
    real = fused.linear_attention_qkv

    def counting(qkv, heads):
        calls.append(tuple(qkv.shape))
        return real(qkv, heads)

    monkeypatch.setattr(fused, "linear_attention_qkv", counting)
    return calls


def _three_products(self, x, mask=None):
    """``MultiheadLinearAttention.forward`` as JAX's default path runs it:
    three projections, then the attention on their head-split views."""
    b, d_k = x.shape[0], self.d_model // self.nhead
    q, k, v = (getattr(self, f"linears_{i}")(x).reshape(b, -1, self.nhead, d_k).transpose(1, 2)
               for i in range(3))
    if mask is not None:
        out = attention.linear_attention(q, k, v, mask=mask[:, None])
    else:
        out = fused.linear_attention(q, k, v)
    return self.linears_3(out.transpose(1, 2).reshape(b, -1, self.d_model))


_ONE_PRODUCT = blocks.MultiheadLinearAttention.forward


def _projection(monkeypatch, fused_qkv):
    """The module's own one product, or the three products of
    ``_three_products`` patched in."""
    monkeypatch.setattr(blocks.MultiheadLinearAttention, "forward",
                        _ONE_PRODUCT if fused_qkv else _three_products)


def _attention_layers(model):
    return sum(isinstance(m, blocks.SelfAttentionLayer) for m in model.modules())


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(TINY_SEED)
    x = rng.standard_normal((2, 32, 32, 4, 1)).astype(np.float32)
    jmodel = JaxMaskTransUnet(**TINY)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=TINY_SEED)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "FUSED_QKV", True)
        probs, masks = jax.jit(lambda p, v: jmodel.apply(
            {"params": p}, v, train=False, return_aux=True))(params, jnp.asarray(x))
    return dict(x=x, params=params, probs=np.asarray(probs),
                masks=[np.asarray(m) for m in masks])


def _port_tiny(monkeypatch, tiny, flag):
    _projection(monkeypatch, flag)
    model = load_port(MaskTransUnet(**TINY, device="cpu"), tiny["params"])
    with torch.inference_mode():
        probs, masks = model(t(to_ncdhw(tiny["x"])), return_aux=True)
    return model, from_ncdhw(probs.numpy()), [from_ncdhw(m.numpy()) for m in masks]


def test_seed_keeps_clear_of_the_box_threshold(tiny):
    levels = len(TINY["num_layers"])
    for j, mask in enumerate(tiny["masks"]):
        if TINY["is_roi_list"][levels - 2 - j]:
            assert np.min(np.abs(1.0 - mask[..., 0] - 0.5)) > 1e-5, j


def test_fused_qkv_model_matches_jax_and_the_unfused_port(monkeypatch, tiny):
    calls = _qkv_calls(monkeypatch)
    model, probs, masks = _port_tiny(monkeypatch, tiny, True)
    assert len(calls) == _attention_layers(model) > 0
    assert all(shape[-1] % 3 == 0 for shape in calls)
    np.testing.assert_allclose(probs, tiny["probs"], atol=5e-5, rtol=0)
    assert len(masks) == len(tiny["masks"])
    for got, want in zip(masks, tiny["masks"]):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)

    calls.clear()
    unfused, probs_off, masks_off = _port_tiny(monkeypatch, tiny, False)
    assert not calls
    assert sorted(unfused.state_dict()) == sorted(model.state_dict())
    np.testing.assert_allclose(probs, probs_off, rtol=1e-5, atol=1e-6)
    for got, want in zip(masks, masks_off):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def small_step():
    """One SMALL train step with the flag on in JAX, and the JAX-init
    parameters and batch for the port."""
    rng = np.random.default_rng(STEP_SEED)
    x = rng.standard_normal(PATCH + (1,)).astype(np.float32)
    lbl = np.zeros(PATCH, np.int32)
    lbl[:, 20:44, 24:40, 2:6] = 1
    dw = engine.get_dynamic_weight(
        epochs=3, T=12.0, warmup_step=1, weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
        initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0), final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))[0]
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2, dropout=0.0)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=STEP_SEED)
    jax_crit, _ = jax_criterion_list(5, CRITERIA, jax_binary)

    def loss_fn(p):
        out, masks = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_engine.deep_supervision_loss(out, masks, jnp.asarray(lbl), jax_crit,
                                                jnp.asarray(dw, jnp.float32))[0]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_blocks, "FUSED_QKV", True)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return dict(x=x, lbl=lbl, dw=dw, params=params, loss=float(loss),
                grads=from_flax(jax.tree.map(np.array, grads)))


def _port_step(monkeypatch, small_step, flag):
    _projection(monkeypatch, flag)
    model = load_port(MaskTransUnet(**SMALL, n_layers=2, dropout=0.0, device="cpu"),
                      small_step["params"])
    step = engine.make_train_step(model, get_criterion_list(5, CRITERIA)[0])
    state = engine.create_train_state(model, 1e-4)
    loss, _ = step(state, t(to_ncdhw(small_step["x"])), t(small_step["lbl"]),
                   small_step["dw"], torch.Generator().manual_seed(0))
    return loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_fused_qkv_train_step_matches_jax_and_the_unfused_port(monkeypatch, small_step):
    calls = _qkv_calls(monkeypatch)
    loss, grads = _port_step(monkeypatch, small_step, True)
    assert calls
    np.testing.assert_allclose(loss, small_step["loss"], rtol=1e-5)
    assert set(grads) == set(small_step["grads"])
    worst = worst_grad_error(grads, small_step["grads"])
    assert worst[1] <= 1e-4, worst
    loss_off, grads_off = _port_step(monkeypatch, small_step, False)
    np.testing.assert_allclose(loss, loss_off, rtol=1e-5)
    worst = worst_grad_error(grads, grads_off)
    assert worst[1] <= 1e-4, worst


@pytest.mark.parametrize("b,n,h,d", [(2, 37, 3, 8), (1, 300, 2, 32), (1, 16, 4, 2)])
def test_packed_backward_matches_jax_vjp(b, n, h, d):
    rng = np.random.default_rng(n)
    qkv = rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    g = rng.standard_normal((b, h, n, d)).astype(np.float32)

    def jax_attention(a):
        parts = jnp.split(a, 3, axis=-1)
        q, k, v = (p.reshape(b, n, h, d).transpose(0, 2, 1, 3) for p in parts)
        return jax_ops.linear_attention(q, k, v)

    want, vjp = jax.vjp(jax_attention, jnp.asarray(qkv))
    (want_grad,) = vjp(jnp.asarray(g))

    packed = t(qkv).requires_grad_(True)
    out = fused.linear_attention_qkv(packed, h)
    assert out.shape == (b, h, n, d)
    out.backward(t(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(packed.grad.numpy(), np.asarray(want_grad), rtol=1e-5,
                               atol=1e-6)

    buffer = torch.full_like(packed, float("nan"))
    thirds = fused.split_qkv(buffer, h)
    got = fused.linear_attention_backward(*fused.split_qkv(t(qkv), h), t(g), out=thirds)
    assert all(a.data_ptr() == w.data_ptr() for a, w in zip(got, thirds))
    np.testing.assert_allclose(buffer.numpy(), packed.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_fused_qkv_masked_path_matches_jax(monkeypatch):
    """TransEncoder with a mask: the fused projection's thirds go through
    the plain masked attention, as JAX's fused path goes through its masked
    op."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    mask = rng.random((2, 40, 1)) < 0.6
    jblock = jax_blocks.TransEncoder(16, 2, 32, 2)
    params = random_params(jblock, jnp.asarray(x), seed=2)
    monkeypatch.setattr(jax_blocks, "FUSED_QKV", True)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    calls = _qkv_calls(monkeypatch)
    port = load_port(TransEncoder(16, 2, 32, 2), params)
    with torch.inference_mode():
        got = port(t(x), t(mask))
    assert not calls  # masked: the plain masked op, not the kernel's entry
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _remat_step(monkeypatch, remat):
    """tests/test_torch_remat.py's loss on its model, dropout 0.3
    from the step generator: (loss, output, gradients, layer calls)."""
    monkeypatch.setattr(blocks, "REMAT", remat)
    kw = dict(TINY, roi_size_list=(8, 6, 4), is_roi_list=(False, True, True))
    model = MaskTransUnet(**kw, dropout=0.3, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    model.train()
    calls = []
    for module in model.modules():
        if isinstance(module, blocks.SelfAttentionLayer):
            module.register_forward_pre_hook(lambda *_: calls.append(1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 1, 32, 32, 4)).astype(np.float32))
    labels = torch.from_numpy((rng.random((1, 32, 32, 4)) > 0.7).astype(np.float32))
    with blocks.dropout_generator(torch.Generator().manual_seed(1)):
        out, mask_list = model(x, return_aux=True)
    total = torch.mean((out[:, 1] - labels) ** 2)
    for m in mask_list:
        total = total + torch.mean(m[:, 1] ** 2)
    total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    return total.item(), out.detach(), grads, len(calls), _attention_layers(model)


def test_fused_qkv_under_recompute(monkeypatch):
    qkv_calls = _qkv_calls(monkeypatch)
    loss0, out0, g0, calls0, layers = _remat_step(monkeypatch, "")
    assert len(qkv_calls) == layers
    loss1, out1, g1, calls1, _ = _remat_step(monkeypatch, "attn")
    assert (calls0, calls1) == (layers, 2 * layers)
    assert len(qkv_calls) == 3 * layers  # the recompute took the fused route again
    assert loss0 == loss1 and torch.equal(out0, out1)
    assert sorted(g0) == sorted(g1) and g0
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_fused_stack_configuration_ignores_the_flag(monkeypatch):
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 1, 32, 32, 4)).astype(np.float32))
    state = None
    outs = []
    for flag in (False, True):
        _projection(monkeypatch, flag)
        model = MaskTransUnet(**TINY, device="cpu", fused_s1=True, fused_stack=True)
        if state is None:
            init_random_(model, torch.Generator().manual_seed(4))
            state = model.state_dict()
        model.load_state_dict(state)
        with torch.inference_mode():
            outs.append(model(x, return_aux=True))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
