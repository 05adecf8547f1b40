"""stack_roofline.serve: the least time of the traced windows' fused transformer-stack calls (frozen per window in the configuration's ``stack_calls``; each call's FLOPs at 989 TFLOP/s or its compulsory bytes at 3.35 TB/s) over the device time of the kernels of ``csrc/fused_stack.cu`` (``stack_pack_weights``, ``stack_kv_*``, ``stack_ctx_combine``, ``stack_apply_*``). A configuration or a run without them reads nothing."""

import re

from portbench.roofline import calls_share

KERNELS = re.compile(r"\bstack_(pack_weights|kv_|ctx_combine|apply_)")


def read(ctx):
    return calls_share(ctx, "stack_calls", KERNELS)
