"""serve.copy_ms: host-clock ms per volume of the copy of the volume to the card and of its mask back to the host, each ended by a synchronise, in the traced stretch."""

def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["copy_s"]:
        return None
    return sum(ctx["copy_s"]) / len(ctx["copy_s"]) * 1e3
