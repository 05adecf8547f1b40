"""encoder_ms.serve: device ms per window of the kernels launched while the host is inside the port's encoder spans (``ltu.encoder.*``: the window embedding, the input block, the DownBlocks)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "encoder.")
    if not inside:
        return None
    return program_spans.device_s(trace, inside) / ctx["traced_windows"] * 1e3
