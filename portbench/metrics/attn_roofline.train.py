"""attn_roofline.train: the least time of the traced micro-steps' linear-attention calls, forward and backward (frozen (BH, N, d) per micro-step), over the device time of all lta_* kernels."""

from portbench.roofline import attention_bound_total_s


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    spent = ctx["trace"].kernel_s(lambda name: "lta_" in name)
    if spent <= 0:
        return None
    bound = attention_bound_total_s(ctx["config"]["attention_calls"]["train_step"], backward=True)
    return bound * ctx["traced_steps"] / spent * 100
