"""The port's multi-class path against the JAX package's, on the CPU.

* the 20 multi-class losses of ``Loss_Dict`` on the same seeded softmax
  predictions and one-hot targets, channels-last for JAX, channels-first
  for the port (rtol 1e-5 for sums of a few hundred f32 values in another
  order, atol 1e-7 near 0, as ``test_torch_losses.py``), and
  ``get_multi_criterion_list``;
* the flagship ``MaskTransUnet`` at ``dim_output`` 3 (SMALL, two layers a
  bridge, seeded parameters): probabilities and masks within atol 1e-4 (as
  ``test_torch_model.py``) and the one-hot argmax voxel for voxel, at a seed
  that keeps every ROI mask value and every class margin clear of its
  decision threshold by more than 1e-5;
* the three multi-class CLIs end to end at a tiny size (after
  ``tests/test_cli.py``'s multi-class and MONAI tests):
  ``train3d_multi_class`` -> ``inference_multi_classes`` on the checkpoint
  it wrote, and ``train3d_monai_version``.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lintransunet_tpu.cli import common as jax_common
from lintransunet_tpu.losses import multiclass as jax_multiclass
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu_torch.cli import (inference_multi_classes, postprocess, split_dataset,
                                        train3d_monai_version, train3d_multi_class)
from lintransunet_tpu_torch.cli.common import get_multi_criterion_list
from lintransunet_tpu_torch.compat import from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.losses import functional, multiclass
from lintransunet_tpu_torch.models import MaskTransUnet
from torch_port_helpers import SMALL, load_port, random_params, t

torch.set_num_threads(2)

NAMES = sorted(jax_multiclass.Loss_Dict)
SHAPE = (2, 6, 5, 4)  # (N, H, W, D)


def _loss_inputs(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(SHAPE + (3,)).astype(np.float32) * 2.0
    probs = np.exp(logits) / np.exp(logits).sum(axis=-1, keepdims=True)
    labels = rng.choice(3, size=SHAPE, p=(0.6, 0.25, 0.15))
    return probs, np.eye(3, dtype=np.float32)[labels], labels


def test_registry_names_match():
    assert sorted(multiclass.Loss_Dict) == NAMES and len(NAMES) == 20
    got = multiclass.get_criterions(["CrossEntroLoss", "DiceClassLoss2"])
    assert list(got) == ["CrossEntroLoss", "DiceClassLoss2"]
    assert isinstance(got["DiceClassLoss2"], multiclass.DiceClassLoss2)


@pytest.mark.parametrize("name", NAMES)
def test_loss_matches_jax(name):
    probs, onehot, labels = _loss_inputs(sum(map(ord, name)))
    want = float(jax_multiclass.Loss_Dict[name]()(jnp.asarray(probs), jnp.asarray(onehot)))
    target = functional.one_hot_map(t(labels), 3)
    np.testing.assert_array_equal(target.numpy(), np.moveaxis(onehot, -1, 1))
    got = multiclass.Loss_Dict[name]()(t(np.moveaxis(probs, -1, 1)), target)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), want, rtol=1e-5, atol=1e-7)


def test_multi_criterion_list_matches_jax():
    got, got_eval = get_multi_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    want, want_eval = jax_common.get_multi_criterion_list(
        5, ["CrossEntroLoss", "DiceClassLoss"], jax_multiclass)
    assert [list(level) for level in got] == [list(level) for level in want]
    assert list(got_eval) == list(want_eval)
    assert all(type(fn).__name__ == type(want[i][name]).__name__
               for i, level in enumerate(got) for name, fn in level.items())
    assert all(type(fn).__module__.startswith("lintransunet_tpu_torch")
               for level in got + [got_eval] for fn in level.values())


# --- the flagship at three classes ------------------------------------------

SEED = 6
THREE = dict(SMALL, dim_output=3)


@pytest.fixture(scope="module")
def three_classes():
    rng = np.random.default_rng(SEED)
    x = rng.standard_normal((1, 64, 64, 8, 1)).astype(np.float32)
    jmodel = JaxMaskTransUnet(**THREE, n_layers=2)
    params = random_params(jmodel, jnp.asarray(x), train=False, seed=SEED)
    aux = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=False, return_aux=True))
    hard = jax.jit(lambda p, v: jmodel.apply({"params": p}, v, train=False))
    want_probs, want_masks = aux(params, jnp.asarray(x))
    want_hard = hard(params, jnp.asarray(x))
    port = load_port(MaskTransUnet(**THREE, n_layers=2, device="cpu"), params)
    with torch.inference_mode():
        got_probs, got_masks = port(t(to_ncdhw(x)), return_aux=True)
        got_hard = port(t(to_ncdhw(x)))
    return dict(want_probs=np.asarray(want_probs),
                want_masks=[np.asarray(m) for m in want_masks],
                want_hard=np.asarray(want_hard), got_probs=got_probs.numpy(),
                got_masks=[m.numpy() for m in got_masks], got_hard=got_hard.numpy())


def test_three_class_seed_keeps_clear_of_thresholds(three_classes):
    levels = len(THREE["num_layers"])
    for j, mask in enumerate(three_classes["want_masks"]):
        if THREE["is_roi_list"][levels - 2 - j]:
            assert np.min(np.abs(1.0 - mask[..., 0] - 0.5)) > 1e-5, j
    top2 = np.sort(three_classes["want_probs"], axis=-1)[..., -2:]
    assert np.min(top2[..., 1] - top2[..., 0]) > 1e-5


def test_three_class_flagship_matches_jax(three_classes):
    got, want = three_classes["got_probs"], three_classes["want_probs"]
    assert got.shape == (1, 3, 64, 64, 8) and np.isfinite(got).all()
    np.testing.assert_allclose(from_ncdhw(got), want, atol=1e-4, rtol=0)
    assert len(three_classes["got_masks"]) == len(three_classes["want_masks"]) == 4
    for got_m, want_m in zip(three_classes["got_masks"], three_classes["want_masks"]):
        assert got_m.shape[1] == 3
        np.testing.assert_allclose(from_ncdhw(got_m), want_m, atol=1e-4, rtol=0)
    hard = three_classes["got_hard"]
    np.testing.assert_array_equal(from_ncdhw(hard), three_classes["want_hard"])
    assert set(np.unique(hard)) == {0.0, 1.0} and (hard.sum(axis=1) == 1).all()


def test_fg_only_needs_two_classes():
    model = MaskTransUnet(**dict(THREE, num_layers=(8, 32), roi_size_list=(8, 4),
                                 is_roi_list=(False, True)), n_layers=1, device="cpu")
    with pytest.raises(ValueError, match="dim_output == 2"):
        model(torch.zeros(1, 1, 16, 16, 4), return_aux=False, fg_only=True)


# --- the three CLIs ---------------------------------------------------------

TINY = dict(model_name="MaskTransUnet", num_layers=(8, 32), roi_size_list=(8, 4),
            is_roi_list=(False, True), dim_input=1, dim_output=3, kernel_size=3,
            compute_dtype="float32", attn_layers=1)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Four (8, 32, 32) volumes with a class-1 blob and a class-2 blob in it,
    and a 2-fold split by the port's split tool."""
    root = tmp_path_factory.mktemp("mc")
    data = root / "data"
    os.makedirs(data / "image")
    os.makedirs(data / "label")
    rng = np.random.default_rng(5)
    for i in range(4):
        lbl = np.zeros((8, 32, 32), np.uint8)
        lbl[2:5, 8:20, 10:22] = 1
        lbl[3:5, 12:16, 12:16] = 2
        np.save(data / "image" / f"{i:04d}.npy",
                rng.normal(40.0, 60.0, (8, 32, 32)).astype(np.float32))
        np.save(data / "label" / f"{i:04d}.npy", lbl)
    split = str(root / "split.json")
    saved = sys.argv
    sys.argv = ["prog", "--dir_data", str(data), "--k_folds", "2", "--out", split]
    try:
        split_dataset.main()
    finally:
        sys.argv = saved
    return {"data": str(data), "split": split}


def _train_args(ws, tmp):
    return types.SimpleNamespace(
        dir_data=ws["data"], is_transform=True, split_ratio=0.9,
        is_pretrained=False, pretrained_dir="", batch_size=1, depth_size=8,
        num_samples=2, device="cpu", epochs=2, eval_epoch=2,
        log_dir=os.path.join(tmp, "runs"), model_dir=os.path.join(tmp, "out"),
        weight_list=(0.1, 1.0), final_weight=(2.0, 1.0),
        initial_weight=(0.1, 1.0), fold_num=0, split_json=ws["split"],
        learning_rate=1e-3, plateau_threshold=1e-2, plateau_cooldown=1, min_lr=1e-7,
        warmup_step=1, weight_T=12.0, seed=0, image_crop=16, eval_depth=8,
        **train3d_multi_class.MULTI_CLASS, **TINY)


def _records(tmp):
    logs = [os.path.join(dp, f) for dp, _, fn in os.walk(os.path.join(tmp, "runs"))
            for f in fn if f == "metrics.jsonl"]
    assert logs
    return [json.loads(line) for line in open(logs[0])]


def test_multiclass_train_and_inference_cli(workspace, tmp_path, monkeypatch):
    train3d_multi_class.main(_train_args(workspace, str(tmp_path)))
    out_root = os.path.join(str(tmp_path), "out")
    run_dir = os.path.join(out_root, os.listdir(out_root)[0])
    assert sorted(os.listdir(os.path.join(run_dir, "fold_0"))) == [
        "model", "temp_model", "train_state"]
    state = torch.load(os.path.join(run_dir, "fold_0", "train_state"), weights_only=True)
    assert state["step"] == 4  # saved after epoch 0: 2 patients x 2 steps
    records = _records(str(tmp_path))
    tags = {r["tag"] for r in records}
    assert {"train/total_loss", "eval/DiceClassLoss", "eval/DiceClassLoss2",
            "eval/DiceClassLoss0", "train/DiceClassLoss2 layer0"} <= tags
    assert all(np.isfinite(r["value"]) for r in records)

    monkeypatch.chdir(tmp_path)
    infer_args = types.SimpleNamespace(
        dir_data=workspace["data"], pretrained_dir=run_dir, batch_size=1, depth_size=8,
        roi_size=16, sw_batch_size=1, overlap=0.6, threshold=0.5,
        criterion_list=inference_multi_classes.CRITERIA, is_save=True,
        saved_folder=str(tmp_path / "pred"), fold_nums=1, split_json=workspace["split"],
        device="cpu", num_classes=3, **TINY)
    inference_multi_classes.main(infer_args)
    summary = json.load(open("summary_4_fold.json"))
    assert sorted(summary) == ["patient_0", "summary_0"]
    assert len(summary["patient_0"]) == 1  # the last test id is dropped
    assert np.isfinite(summary["summary_0"]).all() and len(summary["summary_0"]) == 7
    preds = os.listdir(str(tmp_path / "pred"))
    assert len(preds) == 1
    vol = np.load(os.path.join(str(tmp_path / "pred"), preds[0]))
    assert vol.shape == (8, 32, 32) and vol.dtype == np.uint8  # (D, H, W)
    assert set(np.unique(vol)) <= {0, 1, 2}


def test_largest_component_volume():
    """Rounding, the largest component of the class-1 + class-2 union, p0 =
    1 - p1 - p2, and the (D, H, W) argmax export."""
    probs = np.zeros((1, 3, 10, 10, 4), np.float32)
    probs[0, 0] = 0.8
    probs[0, 1, 1:3, 1:3, 1:3] = 0.9   # a small class-1 blob: dropped
    probs[0, 1, 5:9, 5:9, 0:3] = 0.7   # the big one: kept
    probs[0, 2, 6:7, 6:7, 0:1] = 0.6   # class 2 inside it: kept
    masks = np.zeros((1, 10, 10, 4), np.uint8)
    masks[0, 5:9, 5:9, 0:3] = 1
    hard, target, export = postprocess.largest_component_volume(torch.from_numpy(probs), masks, 3)
    assert hard[0, 1, 1, 1, 1] == 0 and hard[0, 1, 6, 6, 1] == 1 and hard[0, 2, 6, 6, 0] == 1
    torch.testing.assert_close(hard.sum(dim=1), torch.ones(1, 10, 10, 4))
    assert target.shape == (1, 3, 10, 10, 4) and target[0, 1, 6, 6, 1] == 1
    assert export.shape == (4, 10, 10) and export.dtype == np.uint8
    assert export[1, 6, 6] == 1 and export[1, 1, 1] == 0 and export[0, 6, 6] == 1


def test_monai_train_cli(workspace, tmp_path):
    """One optimiser step per batch over the cached pipeline, then its
    artifacts and the multi-class eval metrics."""
    args = _train_args(workspace, str(tmp_path))
    args.epochs, args.eval_epoch = 1, 1
    train3d_monai_version.main(args)
    out_root = os.path.join(str(tmp_path), "out")
    model_dir = os.path.join(out_root, os.listdir(out_root)[0], "fold_0")
    assert sorted(os.listdir(model_dir)) == ["model", "temp_model", "train_state"]
    state = torch.load(os.path.join(model_dir, "train_state"), weights_only=True)
    assert state["step"] == 2  # 2 train volumes, batch 1, one step a batch
    tags = {r["tag"] for r in _records(str(tmp_path))}
    assert "train/total_loss" in tags and "eval/DiceClassLoss2" in tags
