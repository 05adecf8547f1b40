"""mfu_pct.serve: the frozen FLOPs of the windows forwarded in the untraced window, over its seconds, over the bf16 peak of the cards used."""

from portbench.roofline import PEAK_BF16_FLOPS


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    flops = ctx["windows"] * ctx["config"]["flops"]["window"]
    return flops / ctx["window_s"] / (PEAK_BF16_FLOPS * ctx["chips"]) * 100
