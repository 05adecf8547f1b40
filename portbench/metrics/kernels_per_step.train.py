"""kernels_per_step.train: device kernels per micro-step, counted in the trace."""

def read(ctx):
    if ctx.get("kind") != "train" or not ctx["trace"].kernels:
        return None
    return len(ctx["trace"].kernels) / ctx["traced_steps"]
