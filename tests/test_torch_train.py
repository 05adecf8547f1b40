"""The port's binary training step against the JAX package's, in f32 on the CPU.

* the label pyramid, the schedules and ``deep_supervision_loss`` with its
  logs equal to JAX's (rtol 1e-5: f32 sums in another order);
* the optimizer: ``torch.optim.AdamW`` with ``optax.MultiSteps`` semantics
  (``step_times`` 1 and 2) against ``make_optimizer`` on the same gradient
  trees, parameters within 1e-6;
* one full train step of the SMALL MaskTransUnet (two attention layers a
  bridge, dropout 0, f32) against ``jax.value_and_grad`` of the JAX loss:
  the loss within 1e-5 relative and every parameter's gradient within 1e-4
  of its max |JAX| (twenty-odd layers of f32 forward and backward, sums in
  another order; the norms scale differences up by 1/std). A gradient that
  vanishes in exact arithmetic (a bias ahead of an InstanceNorm, or the key
  bias under the token softmax: its max |JAX| is below 1e-5 of the largest
  gradient, rounding noise) is held within 1e-5 of the largest gradient
  instead. Seed 11 keeps every ROI mask value clear of the box threshold,
  and the gradients clear of discrete branches: JAX's own gradients move
  by less than 1e-3 when the parameters move by 1e-7 relative (both
  checked). Seed 6 of ``tests/test_torch_model.py`` does not: there a
  1e-7 move of the parameters moves an encoder conv's gradient by 6.7%;
* dropout from an explicit generator: one seed gives one loss, another
  seed another;
* a resume: 2 steps, save, restore into a fresh state, 1 step equals 3
  steps, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from lintransunet_tpu import engine as jax_engine
from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.engine.train import label_pyramid_kernel as jax_pyramid_kernel
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu.ops import max_pool3d as jax_max_pool3d
from lintransunet_tpu.ops.pool import avg_pool2d as jax_avg_pool2d
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.compat import from_flax, to_ncdhw
from lintransunet_tpu_torch.models import MaskTransUnet, init_random_
from lintransunet_tpu_torch.ops import pool
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)

SEED = 11
PATCH = (1, 64, 64, 8)  # (N, H, W, D)
DYNAMIC = dict(epochs=3, T=12.0, warmup_step=1,
               weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
               initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0),
               final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))
CRITERIA = ["CrossEntroLoss", "DiceClassLoss"]


def _labels(shape=PATCH):
    lbl = np.zeros(shape, np.int32)
    lbl[:, 20:44, 24:40, 2:6] = 1
    return lbl


def test_pool_matches_jax(rng):
    x = rng.standard_normal((2, 3, 8, 6, 4)).astype(np.float32)
    want = jax_max_pool3d(jnp.asarray(np.moveaxis(x, 1, -1)), (2, 2, 1), (2, 2, 1))
    got = pool.max_pool3d(t(x), (2, 2, 1), (2, 2, 1))
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 1, -1), np.asarray(want))
    y = rng.standard_normal((2, 3, 9, 7)).astype(np.float32)
    want = jax_avg_pool2d(jnp.asarray(np.moveaxis(y, 1, -1)), 5, 2, 2)
    got = pool.avg_pool2d(t(y), 5, 2, 2)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(want),
                               rtol=1e-6, atol=1e-7)


def test_label_pyramid_matches_jax():
    lbl = _labels((2, 64, 64, 16))
    assert [engine.label_pyramid_kernel(k) for k in range(6)] == [
        jax_pyramid_kernel(k) for k in range(6)]
    want = jax_max_pool3d(jnp.asarray(lbl, jnp.float32)[..., None], (2, 2, 1))
    got = pool.max_pool3d(t(lbl).float()[:, None], (2, 2, 1))
    for k in range(1, 4):
        np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(want[..., 0]))
        kern = engine.label_pyramid_kernel(k)
        want = jax_max_pool3d(want, kern, kern)
        got = pool.max_pool3d(got, kern, kern)


def test_dynamic_weights_match_jax():
    assert engine.get_dynamic_weight(**DYNAMIC) == jax_engine.get_dynamic_weight(**DYNAMIC)
    for step in (-3, 0, 7, 50):
        assert engine.get_weight(step, 12.0, 0.1, 0.3, 1.0) == \
            jax_engine.get_weight(step, 12.0, 0.1, 0.3, 1.0)


# The metric sequence of ``tests/test_engine.py``, and one that reduces the
# LR, improves during the cooldown that follows, then stalls: there JAX's
# scheduler (and the port's) keeps the cooldown on the improving epoch and
# lowers the LR one epoch later than torch's.
PLATEAU_SEQUENCES = {
    "test_engine": list(np.random.default_rng(0).random(40) * 2) + [1.5] * 20,
    "improve_in_cooldown": [1.0] * 7 + [0.5] + [0.5] * 9,
}


@pytest.mark.parametrize("sequence", sorted(PLATEAU_SEQUENCES))
def test_plateau_scheduler_matches_jax(sequence):
    """The port's ``ReduceLROnPlateau`` gives JAX's LR on every epoch, its
    LR goes into the optimizer through ``set_learning_rate``, and a
    ``state_dict()`` round trip halfway resumes identically."""
    metrics = PLATEAU_SEQUENCES[sequence]
    lin = nn.Linear(1, 1)
    state = engine.TrainState(lin, engine.make_optimizer(lin.parameters(), 1e-4))
    sched = engine.ReduceLROnPlateau(lr=1e-4)
    ours = jax_engine.ReduceLROnPlateau(lr=1e-4)
    assert sched.state_dict() == ours.state_dict()
    for i, metric in enumerate(metrics):
        if i == len(metrics) // 2:
            sched = engine.ReduceLROnPlateau(**sched.state_dict())
        engine.set_learning_rate(state, sched.step(metric))
        assert engine.get_learning_rate(state) == ours.step(metric)
        assert sched.state_dict() == ours.state_dict()
    if sequence == "improve_in_cooldown":
        # the sequence reaches the case where torch's scheduler differs
        torch_sched = torch.optim.lr_scheduler.ReduceLROnPlateau(
            torch.optim.SGD(nn.Linear(1, 1).parameters(), lr=1e-4), factor=0.8,
            patience=5, threshold=1e-2, cooldown=1, min_lr=1e-7)
        lrs = []
        for metric in metrics:
            torch_sched.step(metric)
            lrs.append(torch_sched.optimizer.param_groups[0]["lr"])
        ours = jax_engine.ReduceLROnPlateau(lr=1e-4)
        assert lrs != [ours.step(metric) for metric in metrics]


def _pyramid_preds(rng, n_classes=2):
    """Softmax predictions at the SMALL pyramid's shapes: the output, then
    mask_list coarse -> fine (channels-last, as JAX's)."""
    shapes = [(1, 64, 64, 8), (1, 4, 4, 4), (1, 8, 8, 4), (1, 16, 16, 8), (1, 32, 32, 8)]
    preds = []
    for s in shapes:
        logits = rng.standard_normal(s + (n_classes,)).astype(np.float32)
        preds.append(np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    return preds[0], preds[1:]


@pytest.mark.parametrize("num_classes", [None, 3])
def test_deep_supervision_loss_matches_jax(rng, num_classes):
    if num_classes is None:
        jax_crit, _ = jax_criterion_list(5, CRITERIA, jax_binary)
        crit, _ = get_criterion_list(5, CRITERIA)
        weight, lbl = None, _labels()
    else:  # a layout-free criterion on the one-hot targets, with criterion weights
        jax_crit = [{"Overlap": lambda p, q: jnp.mean(p * q)}] * 5
        crit = [{"Overlap": lambda p, q: torch.mean(p * q)}] * 5
        weight, lbl = [0.7], rng.integers(0, 3, PATCH).astype(np.int32)
    out, masks = _pyramid_preds(rng, num_classes or 2)
    dw = engine.get_dynamic_weight(**DYNAMIC)[2]
    want, want_logs = jax_engine.deep_supervision_loss(
        jnp.asarray(out), [jnp.asarray(m) for m in masks], jnp.asarray(lbl),
        jax_crit, jnp.asarray(dw, jnp.float32), weight, num_classes)
    got, got_logs = engine.deep_supervision_loss(
        t(to_ncdhw(out)), [t(to_ncdhw(m)) for m in masks], t(lbl), crit, dw,
        weight, num_classes)
    assert list(got_logs) == list(want_logs)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for name, value in got_logs.items():
        np.testing.assert_allclose(value.item(), float(want_logs[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


class _Params(nn.Module):
    def __init__(self, tree):
        super().__init__()
        for name, value in tree.items():
            self.register_parameter(name, nn.Parameter(t(value).clone()))


@pytest.mark.parametrize("step_times", [1, 2])
def test_optimizer_matches_optax(step_times):
    rng = np.random.default_rng(step_times)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    tx = jax_engine.make_optimizer(1e-2, step_times)
    jax_params = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jax_params)
    model = _Params(params)
    state = engine.create_train_state(model, 1e-2, step_times)
    for i in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        updates, opt_state = tx.update(jax.tree.map(jnp.asarray, grads), opt_state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for name, p in model.named_parameters():
            p.grad = t(grads[name]).clone()
        engine.apply_gradients(state)
        assert (state.step, state.gradient_step) == (i + 1, (i + 1) // step_times)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jax_params[name]),
                                       rtol=0, atol=1e-6, err_msg=f"{name} step {i}")


@pytest.fixture(scope="module")
def small_step():
    """One SMALL train step, loss and gradients, in both packages."""
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal(PATCH + (1,)).astype(np.float32)
    lbl = _labels()
    dw = engine.get_dynamic_weight(**DYNAMIC)[0]
    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2, dropout=0.0)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=SEED)
    jax_crit, _ = jax_criterion_list(5, CRITERIA, jax_binary)

    def loss_fn(p, images, labels, weights):
        out, masks = jmodel.apply({"params": p}, images, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        loss, _ = jax_engine.deep_supervision_loss(out, masks, labels, jax_crit, weights)
        return loss, masks

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    args = (jnp.asarray(x), jnp.asarray(lbl), jnp.asarray(dw, jnp.float32))
    (want_loss, masks), grads = value_and_grad(params, *args)
    moved = jax.tree.map(
        lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape)).astype(np.float32), params)
    moved_grads = value_and_grad(moved, *args)[1]

    model = load_port(MaskTransUnet(**SMALL, n_layers=2, dropout=0.0, device="cpu"), params)
    crit, _ = get_criterion_list(5, CRITERIA)
    state = engine.create_train_state(model, 1e-4)
    step = engine.make_train_step(model, crit)
    loss, logs = step(state, t(to_ncdhw(x)), t(lbl), dw, torch.Generator().manual_seed(0))
    got_grads = {name: p.grad.clone() for name, p in model.named_parameters()}
    want_grads, moved_grads = (from_flax(jax.tree.map(np.asarray, g))
                               for g in (grads, moved_grads))
    return dict(loss=loss.item(), want_loss=float(want_loss), logs=logs,
                masks=[np.asarray(m) for m in masks], grads=got_grads,
                want_grads=want_grads, moved_grads=moved_grads, state=state)


def _grad_errors(got, want):
    """{name: max |got - want| over max |want|, or over 1e-1 of the
    largest gradient where the gradient vanishes (max |want| below 1e-5 of
    it), so that 1e-4 on that share is 1e-5 of the largest gradient}."""
    top = max(w.abs().max().item() for w in want.values())
    errors = {}
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale < 1e-5 * top:
            scale = 1e-1 * top
        errors[name] = (got[name] - w).abs().max().item() / scale
    return errors


def test_small_step_seed_keeps_clear_of_the_box_threshold(small_step):
    levels = len(SMALL["num_layers"])
    for j, mask in enumerate(small_step["masks"]):
        if SMALL["is_roi_list"][levels - 2 - j]:
            assert np.min(np.abs(1.0 - mask[..., 0] - 0.5)) > 1e-5, j
    moved = _grad_errors(small_step["moved_grads"], small_step["want_grads"])
    assert max(moved.values()) < 1e-3, max(moved.items(), key=lambda kv: kv[1])


def test_small_train_step_matches_jax(small_step):
    assert np.isfinite(small_step["loss"])
    np.testing.assert_allclose(small_step["loss"], small_step["want_loss"], rtol=1e-5)
    assert len(small_step["logs"]) == 10
    grads, want = small_step["grads"], small_step["want_grads"]
    assert set(grads) == set(want)
    assert all(grads[name].shape == w.shape for name, w in want.items())
    errors = _grad_errors(grads, want)
    assert max(errors.values()) <= 1e-4, max(errors.items(), key=lambda kv: kv[1])
    state = small_step["state"]
    assert (state.step, state.gradient_step) == (1, 1)


def _train_setup(step_times=1, dropout=0.3):
    model = MaskTransUnet(**SMALL, n_layers=1, dropout=dropout, device="cpu")
    init_random_(model, torch.Generator().manual_seed(SEED))
    crit, _ = get_criterion_list(5, CRITERIA)
    state = engine.create_train_state(model, 1e-3, step_times)
    rng = np.random.default_rng(1)
    x = t(to_ncdhw(rng.standard_normal(PATCH + (1,)).astype(np.float32)))
    return state, engine.make_train_step(model, crit), x, t(_labels())


def test_dropout_draws_from_the_step_generator():
    state, step, x, lbl = _train_setup()
    dw = engine.get_dynamic_weight(**DYNAMIC)[0]
    state.model.train()
    with torch.no_grad():
        losses = [step.loss_fn(x, lbl, dw, torch.Generator().manual_seed(s))[0].item()
                  for s in (3, 3, 4)]
        state.model.eval()
        no_dropout = step.loss_fn(x, lbl, dw, None)[0].item()
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]
    assert no_dropout not in losses


def test_fused_configuration_refuses_train_mode():
    model = MaskTransUnet(**SMALL, n_layers=1, device="cpu", fused_s1=True)
    assert not model.training
    with pytest.raises(ValueError, match="eval only"):
        model.train()
    model.eval()


@pytest.mark.parametrize("step_times", [1, 3])
def test_resume_is_exact(tmp_path, step_times):
    dw = engine.get_dynamic_weight(**DYNAMIC)[0]

    def run(state, step, x, lbl, steps):
        for i in steps:
            step(state, x, lbl, dw, torch.Generator().manual_seed(i))

    straight = _train_setup(step_times)
    run(*straight, range(3))
    first = _train_setup(step_times)
    run(*first, range(2))
    path = str(tmp_path / "state.pt")
    sched = engine.ReduceLROnPlateau(lr=1e-4)
    for metric in (1.0,) * 7 + (0.5,):
        sched.step(metric)
    saved = {"epoch": 4, "best_eval_loss": 0.5, "scheduler": sched.state_dict()}
    engine.save_train_state(path, first[0], aux=saved)
    resumed = _train_setup(step_times)
    _, aux = engine.restore_train_state(path, resumed[0])
    assert aux == saved
    # the scheduler comes back as the JAX CLIs rebuild theirs
    assert engine.ReduceLROnPlateau(**aux["scheduler"]) == sched
    run(*resumed, range(2, 3))
    a, b = straight[0], resumed[0]
    assert (a.step, a.mini_step, a.gradient_step) == (b.step, b.mini_step, b.gradient_step)
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for sa, sb in zip(a.optimizer.state_dict()["state"].values(),
                      b.optimizer.state_dict()["state"].values()):
        for key in sa:
            assert torch.equal(sa[key], sb[key]), key
    if step_times > 1:
        assert all(torch.equal(x, y) for x, y in zip(a.acc_grads, b.acc_grads))
