"""kernels_per_window.serve: device kernels per window, counted in the trace."""

def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["trace"].kernels:
        return None
    return len(ctx["trace"].kernels) / ctx["traced_windows"]
