"""The port's headline benchmark (``lintransunet_tpu_torch.bench``) against the
JAX package's ``bench.py``, on the CPU.

* ``--quick --device cpu`` runs and prints one JSON line with ``bench.py``'s
  metric string, a finite positive value and its unit (and the device).
* The window count and patch-equivalents equal those from JAX's
  ``dense_window_starts`` of the padded extent, at the quick and the full
  geometries.
* The quick serving set-up in f32 with JAX's parameters
  (``tests/torch_port_helpers``, no real 5-level init) gives JAX's runner
  output (``bench.py``'s runner: fg-only forward, constant blend, overlap
  0.6) voxel for voxel, on the volume ``bench.py`` draws; the seed is
  checked clear of the box threshold and of the class margin.
* ``--train``'s images, labels, dynamic weights and criteria equal
  ``bench.py:train_bench``'s (``bench.py:186-203``), and the training set-up
  and its timing run on the CPU at the quick widths on a small patch.
* ``LINTRANSUNET_FUSED_S1`` / ``LINTRANSUNET_FUSED_STACK`` build the fused
  configuration; without a card the default device raises.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.engine import SlidingWindowRunner as JaxRunner
from lintransunet_tpu.engine import make_eval_forward as jax_eval_forward
from lintransunet_tpu.engine import sliding_window as jsw
from lintransunet_tpu.engine.schedule import get_dynamic_weight as jax_dynamic_weight
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch import bench
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.compat import from_flax, from_ncdhw
from torch_port_helpers import random_params

torch.set_num_threads(2)

SEED = 10  # clear of the box threshold and the class margin (checked below; 0-9 are not)


def test_quick_bench_prints_one_json_line(capsys):
    result = bench.main(["--quick", "--device", "cpu", "--runs", "1"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.strip()]
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert printed == result
    assert printed["metric"] == ("96^3 patches/sec/chip sliding-window CT inference "
                                 "(MaskTransUnet bf16, 64x64x8 windows, overlap 0.6)")
    assert printed["unit"] == "patches/sec/chip" and printed["device"] == "cpu"
    assert np.isfinite(printed["value"]) and printed["value"] > 0


@pytest.mark.parametrize("volume,roi", [((1, 64, 64, 24), (64, 64, 8)),
                                        ((1, 512, 512, 144), (512, 512, 64)),
                                        ((1, 512, 512, 144), (512, 512, 32)),
                                        ((1, 512, 512, 40), (512, 512, 64))])
def test_window_count_matches_jax(volume, roi):
    spatial = jsw.padded_spatial_shape(volume[1:4], roi)
    want = jsw.dense_window_starts(spatial, roi, 0.6).shape[0]
    windows, patch_equiv = bench.window_count(volume, roi)
    assert windows == want
    assert patch_equiv == want * roi[0] * roi[1] * roi[2] * volume[0] / 96 ** 3
    if volume[3] == 144 and roi[2] == 64:
        assert windows == 5


@pytest.fixture(scope="module")
def quick_serving():
    """bench.py's quick runner in f32 on JAX's side, and the port's quick
    set-up on the same parameters."""
    shape = (1,) + bench.QUICK_VOLUME + (1,)
    volume = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jmodel = JaxMaskTransUnet(**bench.QUICK)
    params = random_params(jmodel, jnp.zeros((1,) + bench.QUICK_ROI + (1,)), train=False,
                           seed=SEED)
    forward = jax_eval_forward(jmodel)
    with pytest.MonkeyPatch.context() as mp:
        # one compiled forward for the grid (the scan form of the blend)
        mp.setattr(jsw, "STATIC_UNROLL_MAX", 0)
        runner = JaxRunner(lambda x, p: forward(p, x), bench.QUICK_ROI, 1, overlap=0.6,
                           mode="constant", depth_bucket=bench.QUICK_ROI[2], chunk_bucket=1,
                           derive_background=forward.fg_only)
        want = np.asarray(runner(jnp.asarray(volume), params))
    aux = jax.jit(lambda p, x: jmodel.apply({"params": p}, x, train=False, return_aux=True))
    windows = [volume[..., z:z + bench.QUICK_ROI[2], :] for z in
               jsw.dense_window_starts(bench.QUICK_VOLUME, bench.QUICK_ROI, 0.6)[:, 2]]
    margins = [aux(params, jnp.asarray(w)) for w in windows]
    serving = bench.serving_setup(quick=True, device="cpu", dtype=torch.float32,
                                  state=from_flax(params))
    return dict(volume=volume, want=want, margins=margins, serving=serving)


def test_quick_seed_keeps_clear_of_thresholds(quick_serving):
    levels = len(bench.QUICK["num_layers"])
    for probs, masks in quick_serving["margins"]:
        probs = np.asarray(probs)
        assert np.min(np.abs(probs[..., 1] - probs[..., 0])) > 1e-5
        for j, mask in enumerate(masks):
            if bench.QUICK["is_roi_list"][levels - 2 - j]:
                assert np.min(np.abs(1.0 - np.asarray(mask)[..., 0] - 0.5)) > 1e-5, j


def test_quick_serving_matches_jax_runner_voxel_for_voxel(quick_serving):
    serving = quick_serving["serving"]
    np.testing.assert_array_equal(from_ncdhw(serving.volume.numpy()), quick_serving["volume"])
    assert (serving.roi, serving.windows) == (bench.QUICK_ROI, 7)
    got = from_ncdhw(serving.runner(serving.volume).numpy())
    want = quick_serving["want"]
    assert got.shape == want.shape == (1,) + bench.QUICK_VOLUME + (2,)
    np.testing.assert_array_equal(got, want)
    assert 0 < got[..., 1].mean() < 1


def test_train_inputs_match_bench_py():
    """bench.py:186-203: the patch from default_rng(0) in bf16, the label
    box, the epoch-0 weights and the 5-level criteria."""
    images, labels = bench.train_inputs(1, "cpu")
    shape = (1,) + bench.TRAIN_PATCH + (1,)
    want = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(shape),
                                  jnp.bfloat16).astype(jnp.float32))
    assert images.dtype == torch.bfloat16 and images.shape == (1, 1) + bench.TRAIN_PATCH
    np.testing.assert_array_equal(from_ncdhw(images.float().numpy()), want)
    lbl = np.zeros(shape[:4], np.int64)
    lbl[:, 200:320, 220:300, 8:24] = 1
    np.testing.assert_array_equal(labels.numpy(), lbl)
    want_weights = jax_dynamic_weight(
        epochs=1, T=12.0, warmup_step=10, weight_list=(0.05, 0.05, 0.1, 0.1, 1.0),
        initial_weight=(0.1, 0.2, 0.3, 0.4, 1.0), final_weight=(2.0, 1.5, 1.0, 1.0, 1.0))[0]
    np.testing.assert_array_equal(np.asarray(bench.dynamic_weight()), np.asarray(want_weights))
    want_crit, _ = jax_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"], jax_binary)
    got_crit, _ = get_criterion_list(5, bench.CRITERIA)
    assert [list(level) for level in got_crit] == [list(level) for level in want_crit]
    assert [[type(c).__name__ for c in level.values()] for level in got_crit] == \
        [[type(c).__name__ for c in level.values()] for level in want_crit]


def test_training_setup_and_timing_run_on_the_cpu():
    """The --train path end to end at the quick widths (one attention layer
    a bridge) on a 64 x 64 x 8 patch in f32: one warm step, then 3 synced
    and 3 back-to-back steps, every loss finite."""
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((1, 1, 64, 64, 8)).astype(np.float32))
    labels = torch.zeros((1, 64, 64, 8), dtype=torch.long)
    labels[:, 20:44, 24:40, 2:6] = 1
    training = bench.train_setup(device="cpu", dtype=torch.float32,
                                 model_kwargs=dict(bench.QUICK, n_layers=1),
                                 inputs=(images, labels))
    warm, times, mean_loss, pipelined = bench.time_training(training, runs=1)
    assert len(times) == 3 and pipelined > 0
    assert np.isfinite(warm) and np.isfinite(mean_loss)
    assert (training.state.step, training.state.gradient_step) == (7, 7)


def test_fused_flags_and_the_default_device(monkeypatch):
    monkeypatch.setenv("LINTRANSUNET_FUSED_S1", "1")
    monkeypatch.setenv("LINTRANSUNET_FUSED_STACK", "1")
    assert bench.env_flags() == (True, True)
    serving = bench.serving_setup(quick=True, device="cpu", fused_s1=True, fused_stack=True)
    assert serving.model.fused_s1 and serving.model.fused_stack
    monkeypatch.setenv("LINTRANSUNET_FUSED_STACK", "0")
    assert bench.env_flags() == (True, False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(["--quick"])
