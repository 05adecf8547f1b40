"""The profiler's trace of a traced stretch, reduced to what the per-layer
metrics read: device kernels and copies with their intervals, the host time
each kernel was launched at, the benchmark's own spans (``portbench.*``
annotations) and the host's ATen ops."""

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from portbench import stats

SPAN = "portbench."
COPY_PREFIXES = ("Memcpy", "Memset")


def span(name: str):
    """A named span on the host (a profiler annotation) while tracing."""
    return torch.profiler.record_function(SPAN + name)


class ForwardSpans:
    """Forward hooks that bracket every forward of ``model`` in a
    ``portbench.forward`` span (traced runs only)."""

    def __init__(self, model):
        self._open = []
        self._handles = [model.register_forward_pre_hook(self._enter),
                         model.register_forward_hook(self._exit)]

    def _enter(self, module, args):
        rf = span("forward")
        rf.__enter__()
        self._open.append(rf)

    def _exit(self, module, args, out):
        self._open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self._handles:
            h.remove()


@contextlib.contextmanager
def profiled():
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        yield prof


class Trace:
    """Intervals in seconds from the stretch's start."""

    def __init__(self, prof, start_ns: int, end_ns: int):
        self.start_ns, self.end_ns = start_ns, end_ns
        self.window_s = (end_ns - start_ns) / 1e9
        self.kernels: List[Tuple[float, float, str, int]] = []
        self.copies: List[Tuple[float, float, str]] = []
        self.launches: Dict[int, float] = {}
        self.spans: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self.ops: List[Tuple[float, float, str]] = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            s = (e.start_ns() - start_ns) / 1e9
            t = s + e.duration_ns() / 1e9
            if e.device_type() == cuda:
                if name.startswith(SPAN):  # a span's shadow on the device timeline
                    continue
                if name.startswith(COPY_PREFIXES):
                    self.copies.append((s, t, name))
                else:
                    self.kernels.append((s, t, name, e.correlation_id()))
            elif name.startswith(SPAN):
                self.spans[name[len(SPAN):]].append((s, t))
            elif name.startswith(("cuda", "cu")) and "Launch" in name:
                self.launches[e.correlation_id()] = s
            elif name.startswith("aten::"):
                self.ops.append((s, t, name))
        self.busy = stats.union([(s, t) for s, t, *_ in self.kernels + self.copies])

    def busy_s(self) -> float:
        return stats.length(stats.union(
            (max(s, 0.0), min(t, self.window_s)) for s, t in self.busy if t > 0 and s < self.window_s))

    def kernel_s(self, match) -> float:
        """Summed device seconds of the kernels whose name ``match`` accepts."""
        return sum(t - s for s, t, name, _ in self.kernels if match(name))

    def launched_within(self, spans) -> List[Tuple[float, float, str, int]]:
        """The kernels launched from the host inside any of ``spans``; the
        kernels whose launch the trace does not link are left out."""
        spans = stats.union(spans)
        starts = [a for a, _ in spans]
        out = []
        for k in self.kernels:
            at = self.launches.get(k[3])
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                out.append(k)
        return out

    def linked_share(self) -> float:
        if not self.kernels:
            return 0.0
        return sum(k[3] in self.launches for k in self.kernels) / len(self.kernels)

    def top_ops(self, n: int = 10):
        total = defaultdict(float)
        for s, t, name, _ in self.kernels:
            total[name] += t - s
        for s, t, name in self.copies:
            total[name] += t - s
        return [[name, secs] for name, secs in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The longest idle stretches of the device, each named by what the
        host was doing at its middle: the innermost ATen op, else the
        innermost benchmark span, else "host"."""
        out = []
        longest = sorted(stats.gaps(self.busy, 0.0, self.window_s), key=lambda g: g[0] - g[1])
        for s, t in longest[:n]:
            mid = (s + t) / 2
            label = _innermost(self.ops, mid)
            if label is None:
                label = _innermost([(a, b, SPAN + k) for k, v in self.spans.items()
                                    for a, b in v], mid) or "host"
            out.append([label, t - s])
        return out


def _innermost(intervals, at) -> Optional[str]:
    best = None
    for s, t, name in intervals:
        if s <= at <= t and (best is None or t - s < best[1] - best[0]):
            best = (s, t, name)
    return None if best is None else best[2]
