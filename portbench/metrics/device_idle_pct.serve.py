"""device_idle_pct.serve: share of the traced stretch in which no kernel or copy ran on the device."""

def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["trace"].kernels:
        return None
    trace = ctx["trace"]
    return (1 - trace.busy_s() / trace.window_s) * 100
