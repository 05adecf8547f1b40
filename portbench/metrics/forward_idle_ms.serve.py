"""forward_idle_ms.serve: ms per window in which no kernel or copy ran on the device while the host was inside the port's model forward (``ltu.model``)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "model")
    if not inside:
        return None
    return program_spans.idle_s(trace, inside) / ctx["traced_windows"] * 1e3
