"""K-fold split tool emitting the reference's JSON schema (the port's own
copy of ``lintransunet_tpu/data/split.py``).

Mirrors dataset/split_dataset.py:14-33: sklearn-style KFold(n_splits=8,
shuffle=True) over dataset indices, written as
``{"train_id fold_k": [...], "test_id fold_k": [...]}`` into
``split_dataset_8.json``. Implemented directly (a shuffled index partition)
so no sklearn import is needed at runtime; sklearn produces the identical
partition structure.
"""

import json
from typing import Dict, List

import numpy as np


def kfold_indices(n_items: int, n_splits: int = 8, shuffle: bool = True,
                  seed: int = 0) -> List[Dict[str, list]]:
    indices = np.arange(n_items)
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    fold_sizes = np.full(n_splits, n_items // n_splits, dtype=int)
    fold_sizes[: n_items % n_splits] += 1
    folds = []
    start = 0
    for size in fold_sizes:
        test = np.sort(indices[start:start + size])
        train = np.sort(np.concatenate(
            [indices[:start], indices[start + size:]]))
        folds.append({"train": train.tolist(), "test": test.tolist()})
        start += size
    return folds


def write_split_json(n_items: int, out_path: str = "split_dataset_8.json",
                     n_splits: int = 8, seed: int = 0) -> dict:
    out = {}
    for fold, split in enumerate(kfold_indices(n_items, n_splits, True, seed)):
        out[f"train_id fold_{fold}"] = split["train"]
        out[f"test_id fold_{fold}"] = split["test"]
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
    return out


def load_fold(split_json: str, fold: int):
    with open(split_json) as f:
        data = json.load(f)
    return data[f"train_id fold_{fold}"], data[f"test_id fold_{fold}"]
