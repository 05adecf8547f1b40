"""attn_roofline.serve: the least time of the traced windows' linear-attention calls (frozen (BH, N, d) per window; bytes at 3.35 TB/s or FLOPs at 989 TFLOP/s) over the device time of the lta_* kernels."""

from portbench.roofline import attention_bound_total_s


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    spent = ctx["trace"].kernel_s(lambda name: "lta_" in name)
    if spent <= 0:
        return None
    bound = attention_bound_total_s(ctx["config"]["attention_calls"]["window"])
    return bound * ctx["traced_windows"] / spent * 100
