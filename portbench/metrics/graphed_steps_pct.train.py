"""graphed_steps_pct.train: the share of the traced micro-steps (the port's ``ltu.step`` spans) inside which the port replayed a CUDA graph (a ``ltu.step.replay`` span; the worst rank). A port without the replay span reads nothing."""

from portbench import program_spans


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    found = program_spans.spans(ctx["trace"])
    steps = found and program_spans.named(found, "step")
    replays = found and program_spans.named(found, "step.replay")
    if not steps or not replays:
        return None
    graphed = sum(any(s <= a and b <= t for a, b in replays) for s, t in steps)
    return 100.0 * graphed / len(steps)
