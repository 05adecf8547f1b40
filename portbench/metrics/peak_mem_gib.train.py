"""peak_mem_gib.train: torch.cuda.max_memory_allocated over the run, in GiB (the worst rank)."""

def read(ctx):
    if ctx.get("kind") != "train" or not ctx["peak_bytes"]:
        return None
    return ctx["peak_bytes"] / 2 ** 30
