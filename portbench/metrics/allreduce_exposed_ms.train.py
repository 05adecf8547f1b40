"""allreduce_exposed_ms.train: device ms per micro-step in which NCCL kernels run and no other kernel does (the worst rank)."""

from portbench import stats


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    kernels = ctx["trace"].kernels
    nccl = stats.union((s, t) for s, t, name, _ in kernels if "nccl" in name.lower())
    if not nccl:
        return None
    compute = stats.union((s, t) for s, t, name, _ in kernels if "nccl" not in name.lower())
    return (stats.length(nccl) - stats.overlap(nccl, compute)) / ctx["traced_steps"] * 1e3
