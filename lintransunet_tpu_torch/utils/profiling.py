"""Profiling hooks: ``torch.profiler`` traces, the program's named stages
in them, and synchronised wall-clock timing (port of
``lintransunet_tpu/utils/profiling.py``).

* ``profile_trace(dir)``: a context manager around ``torch.profiler`` that
  writes a TensorBoard-loadable trace (the host's ops and, on the card, its
  kernels);
* ``span(name, seq=None)``: one stage of the program (the runner's parts,
  the model's stages, the train step's phases), a ``ltu.<name>`` range in
  the trace beside the ops and kernels it launched. A span is live exactly
  while a ``torch.profiler`` records on this process; otherwise it costs
  one check of the profiler's flag and returns a shared no-op context. The
  top span of a runner call or a train step carries its sequence number
  (the range's ``seq`` argument, shown where the profiler records shapes).
  Each live span's host-clock bounds (``time.time_ns``, the clock of the
  profiler's timestamps) are also kept: ``recorded()`` returns the last
  ``RECORDED`` of them, for a reader in this process that holds no trace;
* ``counts``: counters of the program's events, kept whether or not a
  profiler records (the train step counts its ``step.replayed`` and
  ``step.eager`` micro-steps, its ``step.captured`` micro-steps and its
  ``step.warmed_up`` signatures);
* ``timed(fn)``: the best wall time of a few calls, each ended by
  ``torch.cuda.synchronize()`` when the result holds a CUDA tensor, since a
  CUDA call returns before the card finishes.
"""

import collections
import contextlib
import time
from typing import Callable, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

from lintransunet_tpu_torch.utils.debug import _tensors

PREFIX = "ltu."
RECORDED = 1 << 14  # live spans kept by ``recorded()``, the oldest dropped first

_recording = torch._C._autograd._profiler_enabled
# A profiler range that opens in ~2 us and is an ordinary op to the profiler
# (no shadow on the device timeline); ``record_function`` where it is missing.
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)
_OFF = contextlib.nullcontext()
_spans = collections.deque(maxlen=RECORDED)


class _Span:
    __slots__ = ("_name", "_range", "_start")

    def __init__(self, name: str, seq: Optional[int]):
        self._name = name
        if _Range is None:
            self._range = record_function(PREFIX + name)
        elif seq is None:
            self._range = _Range(PREFIX + name)
        else:
            self._range = _Range(PREFIX + name, (), {"seq": seq})

    def __enter__(self):
        self._range.__enter__()
        self._start = time.time_ns()

    def __exit__(self, *exc):
        end = time.time_ns()
        self._range.__exit__(*exc)
        _spans.append((self._name, self._start, end))
        return False


def span(name: str, seq: Optional[int] = None):
    """The stage ``name`` as a context manager: a profiler range
    ``ltu.<name>`` while a profiler records, else a no-op."""
    if not _recording():
        return _OFF
    return _Span(name, seq)


def recorded() -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of the last live spans, oldest first."""
    return list(_spans)


counts = collections.Counter()


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
