"""Input layer: CT datasets, transforms, K-fold split, prefetching loader
(the port's own copy of ``lintransunet_tpu/data``; numpy and scipy only)."""

from lintransunet_tpu_torch.data.datasets import (
    CachePanDataset,
    EvaPanCTDataset,
    EvaPanDataset,
    IdPosPanCTDataset,
    MultiClassEvaDataset,
    MultiClassPanCTDataset,
)
from lintransunet_tpu_torch.data.loader import DataLoader
from lintransunet_tpu_torch.data.split import kfold_indices, load_fold, write_split_json

__all__ = [
    "IdPosPanCTDataset",
    "EvaPanCTDataset",
    "MultiClassPanCTDataset",
    "MultiClassEvaDataset",
    "CachePanDataset",
    "EvaPanDataset",
    "DataLoader",
    "kfold_indices",
    "write_split_json",
    "load_fold",
]
