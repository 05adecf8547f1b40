"""device_idle_pct.train: share of the traced stretch in which no kernel or copy ran on the device (the worst rank)."""

def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"].kernels:
        return None
    trace = ctx["trace"]
    return (1 - trace.busy_s() / trace.window_s) * 100
