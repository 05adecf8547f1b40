"""Metric logging: JSONL (always) + TensorBoard (when available); the port's
own copy of ``lintransunet_tpu/engine/metrics.py``.

Replaces the reference's TensorBoard-only observability (train3D.py:218,
utils_3D_embed_full.py:101-113). JSONL is the primary sink so runs are
greppable and diffable without TB; torch's SummaryWriter is attached when
its ``tensorboard`` dependency imports, unless disabled.
"""

import json
import os
import time


class MetricWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        record = {"tag": tag, "value": float(value), "step": int(global_step),
                  "time": time.time()}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), global_step=global_step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class NullWriter:
    """No-op sink for tests and benchmarks."""

    def add_scalar(self, *a, **k):
        pass

    def close(self):
        pass
