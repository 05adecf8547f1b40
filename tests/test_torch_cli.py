"""The port's binary CLIs end to end on the CPU (``device="cpu"``), as
``tests/test_cli.py`` drives the JAX package's: split tool -> ``train3d``
(eval, ``temp_model``, ``train_state``, metrics) -> ``inference_embed_attn``
on the checkpoint it wrote -> ``summary_4_fold.json`` and a (D, H, W)
binary ``.npy``; a full-state resume; and the flags, the split tool's JSON
and ``postprocess`` against the JAX package's."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from lintransunet_tpu.cli import inference_embed_attn as jax_inference
from lintransunet_tpu.cli import inference_multi_classes as jax_inference_multi
from lintransunet_tpu.cli import postprocess as jax_postprocess
from lintransunet_tpu.cli import split_dataset as jax_split_dataset
from lintransunet_tpu.cli import train3d as jax_train3d
from lintransunet_tpu.cli import train3d_monai_version as jax_train3d_monai
from lintransunet_tpu.cli import train3d_multi_class as jax_train3d_multi
from lintransunet_tpu_torch import engine
from lintransunet_tpu_torch.cli import (inference_embed_attn, inference_multi_classes,
                                        postprocess, split_dataset, train3d,
                                        train3d_monai_version, train3d_multi_class)
from lintransunet_tpu_torch.cli.common import build_model
from lintransunet_tpu_torch.core.config import MODEL_NAMES, InferenceConfig, TrainConfig
from torch_port_helpers import CLI_TINY, cli_infer_args, cli_train_args, cli_workspace

torch.set_num_threads(2)

TINY = CLI_TINY


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    return cli_workspace(str(tmp_path_factory.mktemp("ws")))


def _run_main(main, argv):
    saved = sys.argv
    sys.argv = ["prog"] + argv
    try:
        return main()
    finally:
        sys.argv = saved


def _metric_tags(tmp):
    logs = [os.path.join(dp, f) for dp, _, fn in os.walk(os.path.join(tmp, "runs"))
            for f in fn if f == "metrics.jsonl"]
    assert logs
    return [json.loads(line) for line in open(logs[0])]


def test_train_and_inference_cli(workspace, tmp_path, monkeypatch):
    args = cli_train_args(workspace, str(tmp_path))
    train3d.main(args)

    out_root = os.path.join(str(tmp_path), "out")
    run_dirs = os.listdir(out_root)
    model_dir = os.path.join(out_root, run_dirs[0], "fold_0")
    assert sorted(os.listdir(model_dir)) == ["model", "temp_model", "train_state"]
    records = _metric_tags(str(tmp_path))
    tags = {r["tag"] for r in records}
    assert "train/total_loss" in tags
    assert "eval/DiceClassLoss" in tags
    assert all(np.isfinite(r["value"]) for r in records if r["tag"].startswith("train/"))

    monkeypatch.chdir(tmp_path)
    inference_embed_attn.main(cli_infer_args(
        workspace, os.path.join(out_root, run_dirs[0]), str(tmp_path / "pred")))
    summary = json.load(open("summary_4_fold.json"))
    assert sorted(summary) == ["patient_0", "summary_0"]
    assert len(summary["patient_0"]) == 1  # the last test id is dropped
    assert np.isfinite(summary["summary_0"]).all() and len(summary["summary_0"]) == 4
    preds = os.listdir(str(tmp_path / "pred"))
    assert len(preds) == 1
    vol = np.load(os.path.join(str(tmp_path / "pred"), preds[0]))
    assert vol.shape == (8, 32, 32)  # (D, H, W) full-volume export
    assert set(np.unique(vol)) <= {0.0, 1.0}


def test_full_state_resume(workspace, tmp_path):
    """A resume restores the full train state and continues at the next
    epoch: the second run trains epoch 1 on top of the first run's 4 steps."""
    args = cli_train_args(workspace, str(tmp_path))
    args.epochs, args.eval_epoch = 1, 1
    train3d.main(args)
    out_root = os.path.join(str(tmp_path), "out")
    run_dir = os.path.join(out_root, os.listdir(out_root)[0])
    first = torch.load(os.path.join(run_dir, "fold_0", "train_state"), weights_only=True)
    assert (first["step"], first["aux"]["epoch"]) == (4, 0)

    args2 = cli_train_args(workspace, str(tmp_path / "second"))
    args2.epochs, args2.eval_epoch = 2, 1
    args2.is_pretrained, args2.pretrained_dir = True, run_dir
    train3d.main(args2)
    out2 = os.path.join(str(tmp_path / "second"), "out")
    second = torch.load(os.path.join(out2, os.listdir(out2)[0], "fold_0", "train_state"),
                        weights_only=True)
    assert (second["step"], second["aux"]["epoch"]) == (8, 1)
    assert second["aux"]["global_step"] == first["aux"]["global_step"] + 2
    assert second["aux"]["scheduler"]["best"] <= first["aux"]["scheduler"]["best"]


CLIS = {"train3d": (train3d, jax_train3d),
        "inference_embed_attn": (inference_embed_attn, jax_inference),
        "train3d_multi_class": (train3d_multi_class, jax_train3d_multi),
        "inference_multi_classes": (inference_multi_classes, jax_inference_multi),
        "train3d_monai_version": (train3d_monai_version, jax_train3d_monai)}


@pytest.mark.parametrize("cli", list(CLIS))
def test_flags_match_jax(monkeypatch, cli):
    """The same flag names and defaults as the JAX CLI, but ``device``."""
    port, jax = CLIS[cli]
    monkeypatch.setattr(sys, "argv", ["prog"])
    got, want = vars(port.get_parse()), vars(jax.get_parse())
    assert got.pop("device") == "cuda"
    want.pop("device", None)
    assert got == want
    monkeypatch.setattr(sys, "argv", ["prog", "--device", "cpu", "--num_layers", "8,32",
                                      "--is_roi_list", "false,true"])
    parsed = port.get_parse()
    assert (parsed.device, parsed.num_layers, parsed.is_roi_list) == (
        "cpu", (8, 32), (False, True))


def test_the_card_is_the_default_device():
    assert TrainConfig().device == InferenceConfig().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(types.SimpleNamespace(**TINY))


@pytest.mark.parametrize("name", list(MODEL_NAMES) + ["NoSuchUnet"])
def test_build_model_takes_every_registry_name(name):
    """``--model_name`` builds every model of ``Model_Dict`` (on the CPU when
    asked), and an unknown name raises ``ValueError``."""
    args = types.SimpleNamespace(**dict(TINY, model_name=name), device="cpu")
    if name not in MODEL_NAMES:
        with pytest.raises(ValueError, match="unknown model"):
            build_model(args)
        return
    model = build_model(args)
    assert type(model).__name__ == name
    assert next(model.parameters()).device.type == "cpu"


def test_split_dataset_cli_matches_jax(workspace, tmp_path, capsys):
    outputs = []
    for main, name in ((split_dataset.main, "port.json"), (jax_split_dataset.main, "jax.json")):
        _run_main(main, ["--dir_data", workspace["data"], "--k_folds", "3", "--seed", "5",
                         "--out", str(tmp_path / name)])
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    assert open(tmp_path / "port.json").read() == open(tmp_path / "jax.json").read()


@pytest.mark.parametrize("independent", [False, True])
def test_postprocess_matches_jax(independent):
    onehot = np.zeros((3, 10, 10, 4), np.float32)
    onehot[1, 1:3, 1:3, 1:3] = 1      # small blob (class 1)
    onehot[1, 6:9, 6:9, 0:3] = 1      # big blob (class 1)
    onehot[2, 6:7, 6:7, 0:1] = 1      # class 2 inside the big blob
    onehot[2, 0:1, 8:10, 3:4] = 1     # a lone class-2 blob
    onehot[0] = 1 - onehot[1] - onehot[2]
    got = postprocess.keep_largest_connected_component(onehot, (1, 2), independent, 3)
    want = jax_postprocess.keep_largest_connected_component(onehot, (1, 2), independent, 3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert got[1, 1, 1, 1] == 0 and got[1, 7, 7, 1] == 1


def test_checkpoint_artifacts_round_trip(tmp_path):
    """``save_params`` / ``save_checkpoint`` write one file each by a rename
    (no temporary left), and read back what was written."""
    model = torch.nn.Linear(3, 2)
    engine.save_params(str(tmp_path / "temp_model"), model.state_dict())
    engine.save_checkpoint(str(tmp_path / "model"), {"params": model.state_dict()},
                           aux={"best": float("inf"), "epoch": 3})
    assert sorted(os.listdir(tmp_path)) == ["model", "temp_model"]
    params = engine.restore_params(str(tmp_path / "temp_model"))
    restored = engine.restore_checkpoint(str(tmp_path / "model"))
    for name, value in model.state_dict().items():
        assert torch.equal(params[name], value)
        assert torch.equal(restored["state"]["params"][name], value)
    assert restored["aux"] == {"best": float("inf"), "epoch": 3}
