"""Tiny versions of the benchmark's configurations and mixes for CPU tests:
the same code paths at widths and sizes a test process holds."""

import argparse
import copy

from portbench import generate

SMALL_MASK = dict(num_layers=[8, 16, 32, 32, 64], roi_size_list=[16, 12, 8, 6, 4],
                  is_roi_list=[False, True, True, True, True], dim_input=1, dim_output=2,
                  dropout=0.3, n_layers=2)
SMALL_BOTTLE = dict(num_layers=[8, 16, 32, 32, 64], dim_input=1, dim_output=2, dropout=0.3)


def config(name: str) -> dict:
    c = copy.deepcopy(generate.load_json("configs", name))
    c["model_kwargs"] = dict(SMALL_MASK if c["model"] == "MaskTransUnet" else SMALL_BOTTLE)
    c["compute_dtype"] = "float32"  # this CPU's bf16 conv3d is unreliable at these shapes
    return c


def worklist() -> dict:
    t = generate.load_json("traffic", "ct-worklist")
    t.update(height=64, width=64, depths=[16, 24, 32], window=[64, 64, 8], check_volumes=2,
             profiled_volumes=2)
    return t


def train(name: str = "train-b3x2") -> dict:
    t = generate.load_json("traffic", name)
    t.update(patch=[64, 64, 8], label_box=[[20, 40], [24, 36], [2, 6]], batch=2)
    return t


def args(seed: int = 2 ** 31 + 7, seconds: float = 0.5, trace: int = 0):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)
