"""update_kernels_per_step.train: kernels per micro-step launched while the host was inside the port's update (``ltu.step.update``: the gradient accumulation and AdamW; the worst rank)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "step.update")
    if not inside:
        return None
    return len(trace.launched_within(inside)) / ctx["traced_steps"]
