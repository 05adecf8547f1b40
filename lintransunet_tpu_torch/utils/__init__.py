"""Aux subsystems: NaN guards and profiling (the port's own copy of
``lintransunet_tpu/utils``)."""

from lintransunet_tpu_torch.utils.debug import finite_check, nan_guard
from lintransunet_tpu_torch.utils.profiling import profile_trace, timed

__all__ = ["nan_guard", "finite_check", "profile_trace", "timed"]
