"""The port's epoch loops against the JAX package's, in f32 on the CPU.

The SMALL MaskTransUnet (two attention layers a bridge, dropout 0) with the
same parameters in both packages (``from_flax``) runs ``train_on_epoch`` on
a tiny in-memory loader (2 patients x 2 frames, 2 micro-steps each, frames
resampled from the same numpy Generator, AdamW at lr 1e-4, a
``NullWriter`` that records), then ``eval_on_epoch`` over 2 volumes of 3
windows each through each package's sliding-window runner.

* Each patient's logged loss and terms agree at rtol 1e-4: f32 forward and
  backward summed in another order (one step is held at 1e-5 in
  ``test_torch_train.py``), carried through four AdamW updates.
* The eval's thresholded labels agree on at least 99.9% of voxels, and the
  eval metrics within 1e-4 absolute (a metric is a ratio of voxel counts;
  with every label equal, as here, only f32 summation order is left).

Seed 3 keeps every ROI box clear of the degenerate fisheye grid of
ROADMAP C.3 (non-finite values in both packages), as seed 11 does for
``test_torch_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu import engine as jax_engine
from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.cli.common import make_eval_runner as jax_eval_runner
from lintransunet_tpu.core.config import EvalConfig as JaxEvalConfig
from lintransunet_tpu.engine import loop as jax_loop
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli.common import EvalConfig, get_criterion_list, make_eval_runner
from lintransunet_tpu_torch.engine import loop
from lintransunet_tpu_torch.models import MaskTransUnet
from torch_port_helpers import SMALL, load_port, random_params

torch.set_num_threads(2)

SEED = 3
PATCH = (64, 64, 8)
EVAL_DEPTH = 12           # 3 windows of depth 8 at overlap 0.6
CRITERIA = ["CrossEntroLoss", "DiceClassLoss"]
DYNAMIC = dict(epochs=3, T=12.0, warmup_step=1,
               weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
               initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0),
               final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))
LOSS_RTOL = 1e-4
METRIC_ATOL = 1e-4
MIN_AGREEMENT = 0.999


class Recorder(engine.NullWriter):
    """A writer that keeps what it is given."""

    def __init__(self):
        self.records = []

    def add_scalar(self, tag, value, global_step):
        self.records.append((tag, float(value), int(global_step)))


def _volumes(rng, n, shape):
    """(images (n, H, W, D, 1) f32, labels (n, H, W, D) uint8) with a blob."""
    images = rng.standard_normal((n,) + shape + (1,)).astype(np.float32)
    labels = np.zeros((n,) + shape, np.uint8)
    labels[:, 20:44, 24:40, 2:6] = 1
    return images, labels


def _volumes_small(rng):
    images = rng.standard_normal((2, 4, 4, 2, 1)).astype(np.float32)
    return images, (images[..., 0] > 0).astype(np.uint8)


@pytest.fixture(scope="module")
def loops():
    rng = np.random.default_rng(SEED)
    train_batches = [tuple(a[None] for a in _volumes(rng, 2, PATCH)) for _ in range(2)]
    eval_batches = [tuple(a[None] for a in _volumes(rng, 1, PATCH[:2] + (EVAL_DEPTH,)))
                    for _ in range(2)]
    dw = engine.get_dynamic_weight(**DYNAMIC)[0]

    jmodel = JaxMaskTransUnet(**SMALL, n_layers=2, dropout=0.0)
    params = random_params(jmodel, jnp.zeros((1,) + PATCH + (1,)), train=False, seed=SEED)
    jax_crit, jax_eval_crit = jax_criterion_list(5, CRITERIA, jax_binary)
    jstate = jax_engine.TrainState.create(apply_fn=jmodel.apply, params=params,
                                          tx=jax_engine.make_optimizer(1e-4))
    jax_rec = Recorder()
    jstate, jax_mean, jax_step = jax_loop.train_on_epoch(
        jstate, train_batches, jax_engine.make_train_step(jmodel, jax_crit, donate=False),
        dw, patient_epochs=2, patient_batchsize=1, writer=jax_rec, global_step=0,
        rng=np.random.default_rng(7), jax_rng=jax.random.PRNGKey(0))
    _, jrunner = jax_eval_runner(jmodel, JaxEvalConfig(roi_size=64, depth_size=8))
    jax_metric, _ = jax_loop.eval_on_epoch(jrunner, eval_batches, jax_eval_crit, jax_rec,
                                           jax_step, runner_args=(jstate.params,))
    jax_preds = [np.asarray(jrunner(jnp.asarray(x[0]), jstate.params)) for x, _ in eval_batches]

    model = load_port(MaskTransUnet(**SMALL, n_layers=2, dropout=0.0, device="cpu"), params)
    crit, eval_crit = get_criterion_list(5, CRITERIA)
    state = engine.create_train_state(model, 1e-4)
    rec = Recorder()
    state, mean, step = loop.train_on_epoch(
        state, train_batches, engine.make_train_step(model, crit), dw, patient_epochs=2,
        patient_batchsize=1, writer=rec, global_step=0, rng=np.random.default_rng(7),
        generator=torch.Generator().manual_seed(0))
    _, runner = make_eval_runner(model, EvalConfig(roi_size=64, depth_size=8))
    metric, _ = loop.eval_on_epoch(runner, eval_batches, eval_crit, rec, step)
    preds = [runner(loop.to_device(x[0], "cpu")).numpy() for x, _ in eval_batches]
    return dict(jax=(jax_rec.records, jax_mean, jax_step, jax_metric, jax_preds),
                port=(rec.records, mean, step, metric, preds), state=state)


def _by_tag(records, prefix):
    return [(tag, value, step) for tag, value, step in records if tag.startswith(prefix)]


def test_train_epoch_matches_jax(loops):
    records, mean, step = loops["port"][:3]
    jax_records, jax_mean, jax_step = loops["jax"][:3]
    got, want = _by_tag(records, "train/"), _by_tag(jax_records, "train/")
    assert [(tag, s) for tag, _, s in got] == [(tag, s) for tag, _, s in want]
    assert len(got) == 2 * 11  # per patient: the total and the 10 level terms
    for (tag, value, s), (_, expected, _) in zip(got, want):
        assert np.isfinite(value)
        np.testing.assert_allclose(value, expected, rtol=LOSS_RTOL, err_msg=f"{tag} {s}")
    np.testing.assert_allclose(mean, jax_mean, rtol=LOSS_RTOL)
    assert step == jax_step == 1
    state = loops["state"]
    assert (state.step, state.gradient_step) == (4, 4)


def test_eval_epoch_matches_jax(loops):
    records, metric, preds = loops["port"][0], loops["port"][3], loops["port"][4]
    jax_records, jax_metric, jax_preds = loops["jax"][0], loops["jax"][3], loops["jax"][4]
    for got, want in zip(preds, jax_preds):
        assert got.shape == (1, 2) + PATCH[:2] + (EVAL_DEPTH,)
        agree = np.mean((got[:, 1] >= 0.5) == (want[..., 1] >= 0.5))
        assert agree >= MIN_AGREEMENT, agree
    got, want = _by_tag(records, "eval/"), _by_tag(jax_records, "eval/")
    assert [(tag, s) for tag, _, s in got] == [(tag, s) for tag, _, s in want]
    assert len(got) == 6
    for (tag, value, _), (_, expected, _) in zip(got, want):
        np.testing.assert_allclose(value, expected, rtol=0, atol=METRIC_ATOL, err_msg=tag)
    np.testing.assert_allclose(metric, jax_metric, rtol=0, atol=METRIC_ATOL)


def test_train_epoch_reads_the_host_once_per_patient(monkeypatch):
    """The loop copies device values to the host once per patient: one
    ``tolist`` of the stacked losses, and no ``item``."""
    calls = {"tolist": 0, "item": 0}
    for name in calls:
        original = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _original=original, **k):
            calls[_name] += 1
            return _original(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)

    def step(state, x, y, dw, generator):
        assert x.shape == (1, 1, 4, 4, 2) and y.dtype == torch.int64
        return x.sum(), {"a": x.mean(), "b": y.float().mean()}

    rng = np.random.default_rng(0)
    batches = [tuple(a[None] for a in _volumes_small(rng)) for _ in range(3)]
    state = engine.create_train_state(torch.nn.Linear(1, 1), 1e-4)
    rec = Recorder()
    loop.train_on_epoch(state, batches, step, [1.0], patient_epochs=4, patient_batchsize=1,
                        writer=rec, global_step=5, rng=rng)
    assert calls == {"tolist": 3, "item": 0}
    assert [(tag, s) for tag, _, s in rec.records] == [
        (tag, s) for s in (5, 6, 7) for tag in ("train/total_loss", "train/a", "train/b")]


def test_batched_predictions_converts_the_layout_and_needs_a_device():
    """Each volume goes to the runner as (N, C, H, W, D) f32 on the runner's
    device; a runner built without a device raises instead of running on
    the CPU unasked."""
    seen = []

    def predictor(x):
        seen.append(x)
        return x.repeat(1, 2, 1, 1, 1)

    rng = np.random.default_rng(1)
    images = rng.normal(size=(1, 1, 8, 8, 4, 1)).astype(np.float32)
    masks = rng.integers(0, 2, size=(1, 1, 8, 8, 4)).astype(np.int32)
    runner = engine.SlidingWindowRunner(predictor, (8, 8, 4), device="cpu")
    (i, got_images, got_masks, predict), = loop.batched_predictions(
        [(images, masks)], runner)
    assert i == 0 and got_images.shape == (1, 8, 8, 4, 1) and got_masks.shape == (1, 8, 8, 4)
    np.testing.assert_array_equal(seen[0].numpy(), np.moveaxis(images[0], -1, 1))
    assert predict.shape == (1, 2, 8, 8, 4)
    with pytest.raises(ValueError, match="no device"):
        next(loop.batched_predictions([(images, masks)],
                                      engine.SlidingWindowRunner(predictor, (8, 8, 4))))
