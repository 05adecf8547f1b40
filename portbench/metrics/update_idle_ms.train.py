"""update_idle_ms.train: ms per micro-step in which no kernel or copy ran on the device while the host was inside the port's step update (``ltu.step.update``; the worst rank)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "step.update")
    if not inside:
        return None
    return program_spans.idle_s(trace, inside) / ctx["traced_steps"] * 1e3
