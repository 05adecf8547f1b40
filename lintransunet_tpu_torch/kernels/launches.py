"""The CUDA kernels a call launches, counted at the host's launch calls.

``torch.profiler`` sees a launch twice: as the host's ``cudaLaunch*``
runtime call and as the device row of the kernel the card ran. On the H100
the device rows are now and then fewer than the kernels that ran (none of a
call, or 4 of a linear-attention backward's 6), so a launch is counted at
the host.
"""

from typing import List, NamedTuple

import torch
from torch.autograd import DeviceType


class Launches(NamedTuple):
    launches: List[str]  # the host's cudaLaunch* calls, one per kernel launched
    ops: List[str]       # the ATen ops that ran (``aten::copy_`` for a copy)
    rows: List[str]      # the device rows the profiler kept: kernels, copies, memsets


def cuda_launches(fn, calls: int = 1) -> Launches:
    """What ``calls`` calls of ``fn`` launched, under ``torch.profiler``
    with the card synchronised before and after."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    host = [e.name for e in events if e.device_type == DeviceType.CPU]
    return Launches([name for name in host if name.startswith("cudaLaunch")],
                    [name for name in host if name.startswith("aten::")],
                    [e.name for e in events if e.device_type == DeviceType.CUDA])
