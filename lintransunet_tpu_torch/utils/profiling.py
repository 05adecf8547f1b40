"""Profiling hooks: ``torch.profiler`` traces and synchronised wall-clock
timing (port of ``lintransunet_tpu/utils/profiling.py``).

* ``profile_trace(dir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace (the host's ops and, on the card, its
  kernels);
* ``timed(fn)``: the best wall time of a few calls, each ended by
  ``torch.cuda.synchronize()`` when the result holds a CUDA tensor, since a
  CUDA call returns before the card finishes.
"""

import contextlib
import time
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

from lintransunet_tpu_torch.utils.debug import _tensors


@contextlib.contextmanager
def profile_trace(log_dir: str, device: str = "cuda"):
    """Trace the block into ``log_dir`` (``<host>_<pid>.<time>.pt.trace.json``).
    ``device="cuda"`` (the default) records the card's kernels beside the
    host's ops and raises without a CUDA device; ``"cpu"`` records the host
    only."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device to trace: pass device='cpu' for a host trace")
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def _sync(value) -> None:
    devices = {t.device for t in _tensors(value) if t.is_cuda}
    for device in devices:
        torch.cuda.synchronize(device)


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 3, **kwargs):
    """(best seconds, last result) of ``iters`` calls after ``warmup`` ones,
    each call synchronised."""
    result = None
    for _ in range(warmup):
        result = fn(*args, **kwargs)
        _sync(result)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _sync(result)
        best = min(best, time.perf_counter() - t0)
    return best, result
