"""The port's own spans in a traced stretch, and what the per-layer readers
take from them: the device time of the kernels launched inside a stage, and
the device's idle time while the host is inside one.

The port (``lintransunet_tpu_torch.utils.profiling.span``) opens a profiler
range ``ltu.<name>`` for each stage while a profiler records, and keeps the
stage's host-clock bounds, which ``profiling.recorded()`` returns; they are
on the clock of the trace's launches and kernels (``time.time_ns``).
A port without them reads None, and so does a trace whose kernels are under
90% linked to their launch."""

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import stats

LINKED = 0.9
Intervals = List[Tuple[float, float]]


def spans(trace) -> Optional[Dict[str, Intervals]]:
    """{name: [(start, end)]}, in seconds from the stretch's start, of the
    port's spans that lie inside the traced stretch."""
    try:
        from lintransunet_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    if trace.linked_share() < LINKED:
        return None
    out = defaultdict(list)
    for name, start, end in recorded():
        if start >= trace.start_ns and end <= trace.end_ns:
            out[name].append(((start - trace.start_ns) / 1e9, (end - trace.start_ns) / 1e9))
    return dict(out) or None


def named(found: Dict[str, Intervals], name: str) -> Intervals:
    """The intervals of the spans called ``name``, or of every span whose
    name starts with it where it ends with a dot ("encoder.")."""
    if name.endswith("."):
        return [iv for key, ivs in found.items() if key.startswith(name) for iv in ivs]
    return found.get(name, [])


def device_s(trace, inside: Intervals, outside: Intervals = ()) -> float:
    """Device seconds of the kernels launched inside ``inside`` and outside
    ``outside``."""
    left_out = {k[3] for k in trace.launched_within(outside)} if outside else set()
    return sum(t - s for s, t, _, corr in trace.launched_within(inside) if corr not in left_out)


def idle_s(trace, inside: Intervals, outside: Intervals = ()) -> float:
    """Seconds of the stretch in which no kernel or copy ran on the device
    while the host was inside ``inside`` and outside ``outside``."""
    where = stats.union(inside)
    if outside:
        cut = stats.union(outside)
        where = [g for s, t in where for g in stats.gaps(cut, s, t)]
    idle = stats.gaps(trace.busy, 0.0, trace.window_s)
    return stats.overlap(idle, where)
