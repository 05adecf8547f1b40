"""conv_unit_roofline.serve: the least time of the traced windows' conv-unit calls (frozen per window in the configuration's ``conv_unit_calls``; each call's FLOPs at 989 TFLOP/s or its compulsory bytes at 3.35 TB/s) over the device time of the kernels of ``csrc/conv_unit.cu`` (``conv_unit_mma`` or ``conv_unit_fma``, and ``stats_reduce``; not the training's ``conv_unit_wgrad*``). A configuration or a run without them reads nothing."""

import re

from portbench.roofline import calls_share

KERNELS = re.compile(r"\b(conv_unit_mma|conv_unit_fma|stats_reduce)\b")


def read(ctx):
    return calls_share(ctx, "conv_unit_calls", KERNELS)
