"""The inference CLI's cell, ``flagship-serve-cli`` (held out of
``BENCHMARK.json`` until its throughput spreads within its bound; the tests
join it to a copy), on the CPU at a tiny size: the folder it writes is what the port's eval dataset reads, its timed
unit is ``inference_embed_attn.main`` itself, a broken export comes out not
correct, and splitting the generator left every other cell's inputs and
weights as they were. On the card, the control comes out not correct."""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from portbench import check, generate, harness, program, readings
from portbench.loops import cli
from portbench.tests import small

CELL = {"name": "flagship-serve-cli", "config": "masktransunet-pancreas",
        "traffic": "ct-cli-folder", "chips": 1}
# the serving per-layer metrics that read the port's spans or the trace, and
# so find something to read in a traced call of ``main``
READ_IN_MAIN = ["mfu_pct.serve", "serve.runner_ms", "attn_roofline.serve", "cudnn_conv_ms.serve",
                "kernels_per_window.serve", "device_idle_pct.serve", "peak_mem_gib.serve",
                "encoder_ms.serve", "bridges_ms.serve", "decoder_ms.serve",
                "forward_idle_ms.serve", "runner_idle_ms.serve"]
SEED = 2 ** 31 + 4099


def joined() -> dict:
    """``BENCHMARK.json`` with the cell in it, as it joins the benchmark once
    its throughput spreads within ``serve_slices_per_s``'s bound: the cell,
    its name in that metric's and the ``READ_IN_MAIN`` metrics' lists, and
    ``outside_runner_ms.serve``."""
    bench = harness.manifest()
    bench["workloads"].append(dict(CELL, why="inference_embed_attn.main over a CT folder"))
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if metric["name"] in ["serve_slices_per_s", *READ_IN_MAIN]:
            metric["workloads"].append(CELL["name"])
    bench["per_layer"].append({"name": "outside_runner_ms.serve", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "cli: cli/inference_embed_attn",
                               "moves": "serve_slices_per_s", "workloads": [CELL["name"]]})
    return bench


def tiny_folder() -> dict:
    t = generate.load_json("traffic", "ct-cli-folder")
    t.update(height=64, width=64, depths=[16, 24, 32], window=[64, 64, 8], check_volumes=2,
             profiled_volumes=2, label_box=[[20, 40], [24, 36], [2, 6]])
    return t


def test_the_folder_reads_back_through_the_ports_eval_dataset(tmp_path):
    from lintransunet_tpu_torch.data import EvaPanCTDataset

    t = tiny_folder()
    hu = generate.hu_folder(SEED, t, "cpu")
    generate.write_folder(str(tmp_path), hu, t)
    assert sorted(os.listdir(tmp_path / "image")) == [f"{i:04d}.npy" for i in range(3)]
    assert sorted(v.shape[0] for v in hu) == sorted(t["depths"])
    window = t["eval_window"]
    assert (EvaPanCTDataset.low_clip, EvaPanCTDataset.high_clip) == tuple(window["hu_window"])
    assert (EvaPanCTDataset.mean, EvaPanCTDataset.std) == (window["mean"], window["std"])
    dataset = EvaPanCTDataset(root=str(tmp_path), depth_size=t["window"][2])
    for i, volume in enumerate(hu):
        assert volume.dtype == np.int16 and volume.shape == (volume.shape[0], 64, 64)
        image, label = dataset[i]
        expected = generate.eval_window(volume, window)
        assert image.dtype == expected.dtype and image.shape == expected.shape
        assert np.array_equal(image, expected)  # bit for bit
        assert label.shape == (1, 64, 64, volume.shape[0]) and label.sum() == 20 * 12 * 4
        assert label[0, 20:40, 24:36, 2:6].all()


def test_the_folder_holds_the_worklists_phantoms_before_their_window():
    t = tiny_folder()
    w = dict(generate.load_json("traffic", "ct-worklist"), height=64, width=64,
             depths=t["depths"])
    p = w["phantom"]
    for hu, normalised in zip(generate.hu_folder(SEED, t, "cpu"),
                              generate.worklist(SEED, w, "cpu")):
        redone = (np.clip(hu.transpose(1, 2, 0), *p["hu_window"]) - p["mean"]) / p["std"]
        # the same draws: only the rounding to whole HU lies between them
        assert np.abs(redone - normalised[0, ..., 0]).max() <= 0.5 / p["std"] + 1e-5


def test_the_cells_flags_are_the_cli_parsers_defaults():
    import sys

    from lintransunet_tpu_torch.cli import inference_embed_attn

    paths = {"dir_data": "d", "pretrained_dir": "p", "split_json": "s.json", "saved_folder": "o"}
    ours = program.cli_args(generate.load_json("configs", CELL["config"]),
                            generate.load_json("traffic", CELL["traffic"]), paths, "cuda")
    argv = sys.argv
    sys.argv = ["inference_embed_attn", "--is_save", "true",
                *(x for k, v in paths.items() for x in (f"--{k}", v))]
    try:
        defaults = inference_embed_attn.get_parse()
    finally:
        sys.argv = argv
    assert vars(ours) == vars(defaults)


def test_the_warm_call_holds_every_shape_of_a_call():
    t = generate.load_json("traffic", CELL["traffic"])
    depths = t["depths"][::-1]
    windows = [generate.window_count(d, t["window"][2], t["overlap"]) for d in depths]
    picked = cli.warm_sample(depths, windows, t["sw_batch"])
    assert sorted(depths[i] for i in picked) == [64, 80, 240]
    last = {(w - 1) % t["sw_batch"] for w in windows}
    assert {(windows[i] - 1) % t["sw_batch"] for i in picked} == last


def _run(capfd, tmp_path, monkeypatch, trace=0):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    config = small.config(CELL["config"])
    assert cli.run(small.args(seed=SEED, seconds=0.5, trace=trace), joined(), CELL, config,
                   tiny_folder(), 0.0, device="cpu") == 0
    # the run leaves nothing behind
    assert not os.path.exists(os.path.dirname(cli.run_dir(CELL["name"])))
    lines = [l for l in capfd.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_timed_unit_is_the_clis_main(trace, capfd, tmp_path, monkeypatch):
    from lintransunet_tpu_torch.cli import inference_embed_attn

    real, calls = inference_embed_attn.main, []

    def main(args, multi_class=False):
        calls.append(args.split_json)
        return real(args, multi_class)

    monkeypatch.setattr(inference_embed_attn, "main", main)
    result = _run(capfd, tmp_path, monkeypatch, trace)
    assert result["correct"] is True and result["failed"] == 0
    timed = calls[1:-1] if trace else calls[1:]
    assert len(timed) >= 1 and result["attempted"] == 3 * len(timed)
    assert calls[0].endswith("split_warm.json")
    assert all(split.endswith("/split.json") for split in timed)
    if trace:
        assert calls[-1].endswith("split_traced.json")
        assert "outside_runner_ms.serve" in {m["name"] for m in harness.cell_metrics(
            joined(), CELL["name"], "per_layer")}
    else:
        assert set(result["metrics"]) == {"serve_slices_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["four_slices_flipped", "a_slice_short"])
def test_a_broken_export_is_not_correct(fault, capfd, tmp_path, monkeypatch):
    from lintransunet_tpu_torch.cli import inference_embed_attn

    real = inference_embed_attn._binary_volume

    def broken(predict, masks, args):
        predict2, target, export = real(predict, masks, args)
        if fault == "four_slices_flipped":
            export = export.copy()
            export[:4] = 1.0 - export[:4]
        else:
            export = export[:-1]
        return predict2, target, export

    monkeypatch.setattr(inference_embed_attn, "_binary_volume", broken)
    result = _run(capfd, tmp_path, monkeypatch)
    assert result["correct"] is False
    checks = result["checks"]
    if fault == "four_slices_flipped":
        assert checks["wrong_side_median"]["value"] > checks["wrong_side_median"]["limit"]
    else:
        assert checks["bad_exports"]["value"] == 2


@pytest.mark.cuda
def test_the_control_is_not_correct():
    """The reference one precision below (fp8 products, bf16 elsewhere) in
    the program's place, at the cell's own size on the card (one seed;
    ``portbench.readings`` reads three or more once the cell is in
    ``BENCHMARK.json``). Run on the card: ``python -m pytest -q portbench/tests -m cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control is read at the cell's size on the card")
    config = generate.load_json("configs", CELL["config"])
    traffic = generate.load_json("traffic", CELL["traffic"])
    values = readings.serve(config, traffic, 2 ** 31 + 79, torch.device("cuda"))["control"]
    correct, checks = check.judge(dict(values, bad_exports=0), CELL["name"])
    assert not correct, checks


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


# sha256 of what the generator and the weights gave on the CPU from SEED,
# taken before the generator was split into the HU phantom and its window
BEFORE = {
    "worklist": "b12fda80ff021ff3331f7506802c1dbaa24d0dce82daa3c4a02814060fa3be04",
    "patches": "53a831cd50c86fe9bb574377f2d416b9feedad71dea6acde5464ed89d4040df4",
    "patches-dp4": "44fddd7ef87b73496616520098f1aeaeb6e40aa860ff6db69794609ac2ade685",
    "masktransunet-pancreas": "aeb1daeb9d7c885a6a9d5bc43a21f2497667afbfaf334236f9f8c645a35d70ad",
    "bottletransunet": "dc79a6529e0f0274600767bcdf2ae2a8e4baddbe3327deb2c4007c20c36502ef",
    "masktransunet-pancreas-fused":
        "aeb1daeb9d7c885a6a9d5bc43a21f2497667afbfaf334236f9f8c645a35d70ad",
}


@pytest.mark.parametrize("what", sorted(BEFORE))
def test_the_other_cells_inputs_and_weights_are_unchanged(what):
    if what == "worklist":
        arrays = generate.worklist(SEED, small.worklist(), "cpu")
    elif what.startswith("patches"):
        name, count = ("train-b3x2-dp4", 4) if what.endswith("dp4") else ("train-b3x2", 6)
        p = generate.patches(SEED, small.train(name), count, "cpu")
        arrays = [p["images"].numpy(), p["label"].numpy()]
    else:
        config = generate.load_json("configs", what)
        state = program.weights(config, generate.substream(SEED, 0), torch.device("cpu"))
        arrays = ([np.frombuffer(k.encode(), np.uint8) for k in sorted(state)]
                  + [state[k].numpy() for k in sorted(state)])
    assert _digest(arrays) == BEFORE[what]
