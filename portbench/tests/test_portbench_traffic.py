import numpy as np
import pytest
import torch

from portbench import generate
from portbench.loops.worklist import check_sample
from portbench.tests import small

SEED = 2 ** 31 + 101


def test_worklist_mix_counts_136_windows_and_38_forwards_a_cycle():
    t = generate.load_json("traffic", "ct-worklist")
    assert t["depths"] == list(range(64, 241, 16))
    assert sum(t["depths"]) / len(t["depths"]) == 152
    windows = [generate.window_count(d, t["window"][2], t["overlap"]) for d in t["depths"]]
    assert sum(windows) == 136
    assert sum(-(-w // t["sw_batch"]) for w in windows) == 38


def test_window_count_is_the_runners_grid():
    from portbench.reference.runner import starts

    for depth in (8, 32, 33, 64, 100, 240):
        assert generate.window_count(depth, 32, 0.6) == len(starts(depth, 32, 0.6))


def test_worklist_is_the_same_for_a_seed_and_shuffled_by_it():
    t = small.worklist()
    a = generate.worklist(SEED, t, "cpu")
    b = generate.worklist(SEED, t, "cpu")
    c = generate.worklist(SEED + 1, t, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert sorted(v.shape[3] for v in a) == sorted(t["depths"]) == sorted(v.shape[3] for v in c)
    assert all(v.shape == (1, 64, 64, v.shape[3], 1) and v.dtype == np.float32 for v in a)
    assert not all(np.array_equal(x, y) for x, y in zip(a, c) if x.shape == y.shape)


def test_volumes_span_the_normalised_hu_window():
    t = small.worklist()
    v = np.concatenate([x.ravel() for x in generate.worklist(SEED, t, "cpu")])
    p = t["phantom"]
    lo = (p["hu_window"][0] - p["mean"]) / p["std"]
    hi = (p["hu_window"][1] - p["mean"]) / p["std"]
    assert v.min() == pytest.approx(lo, abs=1e-5)
    assert lo <= v.min() and v.max() <= hi + 1e-5
    assert (v > lo + 0.5).mean() > 0.2  # the body, not only air


def test_patches_differ_row_by_row_and_repeat_per_seed():
    t = small.train()
    a = generate.patches(SEED, t, 6, "cpu")
    b = generate.patches(SEED, t, 6, "cpu")
    assert torch.equal(a["images"], b["images"]) and torch.equal(a["label"], b["label"])
    flat = a["images"].reshape(6, -1)
    assert all(not torch.equal(flat[i], flat[j]) for i in range(6) for j in range(i))
    assert a["label"].sum() == 20 * 12 * 4


def test_substreams_are_apart_and_fit_a_generator():
    seeds = {generate.substream(2 ** 31 + 9, k) for k in range(6)}
    assert len(seeds) == 6 and all(0 <= s < 2 ** 63 for s in seeds)
    torch.Generator().manual_seed(max(seeds))


def test_check_sample_holds_the_longest_volume():
    depths = [64, 240, 128, 96, 176]
    sample = check_sample(SEED, depths, 3)
    assert 1 in sample and len(sample) == 3
    assert sample == check_sample(SEED, depths, 3)
