"""The served worklist: one client, closed loop. Each volume of the replay
list goes from pageable host memory to the card, through the port's eval
runner, the threshold, and its class-1 mask back to the host, as the
inference CLI serves a test folder; the next volume starts when the mask is
on the host. The list cycles in the seed's order for the whole window."""

import gc
import time

import numpy as np
import torch

from portbench import check, generate, harness, program, stats
from portbench import trace as tracing
from portbench.reference import model as reference
from portbench.reference.runner import blend


def run(args, bench: dict, cell: dict, config: dict, traffic: dict, t0: float,
        device="cuda") -> int:
    dev = torch.device(device)
    threshold = traffic["threshold"]
    state = program.weights(config, generate.substream(args.seed, 0), dev)
    model = program.build_model(config, state, dev)
    runner = program.eval_runner(model, traffic)
    volumes = generate.worklist(args.seed, traffic, dev)
    depths = [v.shape[3] for v in volumes]
    window = traffic["window"]
    windows = [generate.window_count(d, window[2], traffic["overlap"]) for d in depths]
    sample = check_sample(args.seed, depths, traffic["check_volumes"])

    def serve(volume):
        predict = runner(program.to_device(volume, dev))
        return (predict >= threshold).float()[0, 1].cpu()

    for volume in volumes:  # every shape the window will see
        serve(volume)
    harness.sync(dev)
    setup_s = time.perf_counter() - t0

    latencies, kept = [], {}
    slices = served_windows = 0
    start = time.perf_counter()
    i = 0
    while True:
        k = i % len(volumes)
        a = time.perf_counter()
        mask = serve(volumes[k])
        b = time.perf_counter()
        latencies.append(b - a)
        slices += depths[k]
        served_windows += windows[k]
        if k in sample:
            kept[k] = mask
        i += 1
        if b - start >= args.seconds:
            break
    window_s = b - start
    for k in sample - kept.keys():  # a sampled volume the window did not reach, served after it
        kept[k] = serve(volumes[k])

    values = {"serve_slices_per_s": slices / window_s,
              "serve_latency_p90_s": stats.percentile(latencies, 90), "setup_s": setup_s}
    traced, breakdown = None, None
    if args.trace:
        ctx = profile(model, runner, volumes, depths, windows, traffic, dev)
        ctx.update(config=config, chips=1, window_s=window_s, windows=served_windows,
                   peak_bytes=harness.peak(dev))
        values = harness.read_layers(bench, cell["name"], ctx)
        trace = ctx["trace"]
        traced = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    peak = harness.peak(dev)

    del model, runner, mask, serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare(config, traffic, state, volumes, kept, dev)
    print(f"portbench: {cell['name']} served {len(latencies)} volumes, {slices} slices in "
          f"{window_s:.3f} s; reference on volumes {sorted(kept)}: {tally}", flush=True)
    correct, checks = check.judge(tally, cell["name"])
    return harness.emit(bench, cell["name"], args.trace, values, correct, checks,
                        len(latencies), 0, harness.device(dev, 1, peak, traced), breakdown)


def check_sample(seed: int, depths, count: int):
    """Positions in the replay list whose served masks the reference
    judges: the longest volume and ``count - 1`` others drawn from the seed."""
    longest = int(np.argmax(depths))
    others = [i for i in range(len(depths)) if i != longest]
    rng = np.random.default_rng(generate.substream(seed, 4))
    return {longest, *(int(i) for i in rng.choice(others, size=count - 1, replace=False))}


def profiled_sample(depths, count: int):
    """Positions of the ``count`` volumes whose depths lie nearest the
    list's mean (the same depths for every seed), nearest first."""
    mean = sum(depths) / len(depths)
    return sorted(range(len(depths)), key=lambda i: (abs(depths[i] - mean), depths[i]))[:count]


def profile(model, runner, volumes, depths, windows, traffic, dev) -> dict:
    """A traced stretch of whole volumes (the ``profiled_volumes`` whose
    depths lie nearest the list's mean, the same for every seed), with the
    benchmark's spans around the copy in, the runner and the copy out, and
    the model's forwards."""
    chosen = profiled_sample(depths, traffic["profiled_volumes"])
    threshold = traffic["threshold"]
    hooks = tracing.ForwardSpans(model)
    copy_s = []
    try:
        with tracing.profiled() as prof:
            harness.sync(dev)
            start_ns = time.time_ns()
            for k in chosen:
                a = time.perf_counter()
                with tracing.span("copy_in"):
                    x = program.to_device(volumes[k], dev)
                    harness.sync(dev)
                b = time.perf_counter()
                with tracing.span("runner"):
                    predict = (runner(x) >= threshold).float()
                    harness.sync(dev)
                c = time.perf_counter()
                with tracing.span("copy_out"):
                    predict[0, 1].cpu()
                copy_s.append((b - a) + (time.perf_counter() - c))
            harness.sync(dev)
            end_ns = time.time_ns()
    finally:
        hooks.remove()
    trace = tracing.Trace(prof, start_ns, end_ns)
    print(f"portbench: traced {len(chosen)} volumes, {len(trace.kernels)} kernels, "
          f"{trace.linked_share() * 100:.1f}% linked to their launch", flush=True)
    return {"kind": "serve", "trace": trace, "copy_s": copy_s,
            "traced_volumes": len(chosen), "traced_windows": sum(windows[k] for k in chosen)}


def compare(config, traffic, state, volumes, kept, dev) -> dict:
    """The reference's judgement of the kept masks, in f32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference.build(config, torch.float32, dev)
    ref.load_state_dict(state)
    ref.eval()
    tally = check.ServeTally()
    one_hot = config["eval_output"] == "one_hot"
    for k in sorted(kept):
        volume = torch.from_numpy(volumes[k]).movedim(-1, 1).to(dev)
        served_like, soft = blend(ref, volume, traffic, one_hot)
        tally.add(kept[k], served_like, soft, traffic["threshold"])
    return tally.values()
