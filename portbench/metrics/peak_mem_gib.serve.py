"""peak_mem_gib.serve: torch.cuda.max_memory_allocated over the run, in GiB."""

def read(ctx):
    if ctx.get("kind") != "serve" or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
