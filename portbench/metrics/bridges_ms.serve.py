"""bridges_ms.serve: device ms per window of the kernels launched while the host is inside the port's bridge spans (``ltu.bridge.*``: the bottleneck transformer and each ROI bridge's box, warps and transformer)."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "bridge.")
    if not inside:
        return None
    return program_spans.device_s(trace, inside) / ctx["traced_windows"] * 1e3
