"""outside_runner_ms.serve: host-clock ms per volume of the traced inference-CLI call spent outside the port's runner calls (``ltu.runner``, from ``profiling.recorded()``): the loader's hand-over, the threshold and the mask's copy back, the eval losses, the ``.npy`` export, and the call's model build and weight load spread over its volumes."""

from portbench import program_spans, stats


def read(ctx):
    if not ctx.get("cli"):
        return None
    trace = ctx["trace"]
    found = program_spans.spans(trace)
    runner = found and program_spans.named(found, "runner")
    if not runner:
        return None
    return (trace.window_s - stats.length(stats.union(runner))) / ctx["traced_volumes"] * 1e3
