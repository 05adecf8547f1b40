"""mfu_pct.train: the frozen FLOPs of the micro-steps of the untraced window (forward and backward, no recompute), over its seconds, over the bf16 peak of the cards used."""

from portbench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    flops = ctx["steps"] * ctx["chips"] * ctx["config"]["flops"]["train_step"]
    return flops / ctx["window_s"] / (PEAK_BF16_FLOPS * ctx["chips"]) * 100
