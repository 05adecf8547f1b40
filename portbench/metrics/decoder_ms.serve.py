"""decoder_ms.serve: device ms per window of the kernels launched while the host is inside the port's decoder spans (``ltu.decoder.*``: upsampling, mask heads, gates, UpBlocks, the head) and outside its bridge spans."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    inside = found and program_spans.named(found, "decoder.")
    if not inside:
        return None
    bridges = program_spans.named(found, "bridge.")
    return program_spans.device_s(trace, inside, bridges) / ctx["traced_windows"] * 1e3
