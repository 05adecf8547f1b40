"""runner_idle_ms.serve: ms per volume in which no kernel or copy ran on the device while the host was inside the port's runner call (``ltu.runner``) and outside its model forwards (``ltu.model``)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "runner")
    if not inside:
        return None
    model = program_spans.named(found, "model")
    return program_spans.idle_s(trace, inside, model) / ctx["traced_volumes"] * 1e3
