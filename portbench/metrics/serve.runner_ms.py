"""serve.runner_ms: device ms per volume of the kernels that the runner call (pad, window gather, blend, normalisation, background, threshold) launches outside the model's forwards; kernels the trace does not link to their launch are not counted, and with under 90% linked nothing is read."""

def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    trace = ctx["trace"]
    if trace.linked_share() < 0.9 or "runner" not in trace.spans:
        return None
    forward = {k[3] for k in trace.launched_within(trace.spans.get("forward", []))}
    runner = [k for k in trace.launched_within(trace.spans["runner"]) if k[3] not in forward]
    return sum(t - s for s, t, _, _ in runner) / ctx["traced_volumes"] * 1e3
