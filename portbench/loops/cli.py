"""The inference CLI as a user starts it: the port's entry point,
``inference_embed_attn.main(args)``, serving one test folder, called back to
back, closed loop. Whatever ``main`` does (its model build and weight load,
its loader threads, the runner, the threshold, the eval losses, the ``.npy``
export) is inside each timed call; the benchmark only writes the folder, the
weights and the splits at set-up, warms with one call over the volumes that
hold every shape of a call, and reads the exported masks afterwards.

The run works in a directory of its own under ``TMPDIR`` (else the
checkout's ``.portbench_cache``), at a fixed path made anew each run and
removed at its end: ``data/`` (the folder), ``pretrained/fold_0/temp_model``,
the splits, ``prediction/`` (the exports), and ``cli.log``, which takes
``main``'s standard output so that the result stays the last line. Each
call's exports are deleted after it, outside its time, so that no call
writes back another's."""

import contextlib
import gc
import json
import os
import shutil
import time

import numpy as np
import torch

from portbench import check, generate, harness, program, program_spans
from portbench import trace as tracing
from portbench.loops.worklist import check_sample, profiled_sample
from portbench.reference import model as reference
from portbench.reference.runner import blend

CHECKOUT = os.path.dirname(harness.ROOT)


def run_dir(cell: str) -> str:
    base = os.environ.get("TMPDIR") or os.path.join(CHECKOUT, ".portbench_cache")
    return os.path.join(base, "portbench_cli", cell)


def write_split(path: str, ids) -> str:
    """A one-fold split whose test list is ``ids`` and one id more: the CLI
    drops the last test id, as the reference does."""
    ids = [int(i) for i in ids]
    with open(path, "w") as f:
        json.dump({"train_id fold_0": [], "test_id fold_0": ids + [max(ids) + 1]}, f)
    return path


def warm_sample(depths, windows, batch: int):
    """Positions of the volumes that together hold every shape of the
    timed call: the longest (the largest canvas and losses) and, for each
    size of a volume's last forward (its windows modulo ``batch``), the
    shortest volume that has it. The rest of a call runs the same kernels
    at these shapes."""
    picked = {max(range(len(depths)), key=lambda i: depths[i])}
    last = {(windows[i] - 1) % batch for i in picked}
    for i in sorted(range(len(depths)), key=lambda i: depths[i]):
        if (windows[i] - 1) % batch not in last:
            last.add((windows[i] - 1) % batch)
            picked.add(i)
    return sorted(picked)


def run(args, bench: dict, cell: dict, config: dict, traffic: dict, t0: float,
        device="cuda") -> int:
    dev = torch.device(device)
    root = run_dir(cell["name"])
    shutil.rmtree(root, ignore_errors=True)
    try:
        return _run(args, bench, cell, config, traffic, dev, root, t0)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        with contextlib.suppress(OSError):  # the parent only where no other cell's run is in it
            os.rmdir(os.path.dirname(root))


def flush(root: str) -> None:
    """Every file under ``root`` on disk (``fsync``), so that none of the
    run's own writes is written back inside the window."""
    for folder, _, names in os.walk(root):
        for name in names:
            fd = os.open(os.path.join(folder, name), os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def _run(args, bench, cell, config, traffic, dev, root, t0) -> int:
    state = program.weights(config, generate.substream(args.seed, 0), dev)
    hu = generate.hu_folder(args.seed, traffic, dev)
    generate.write_folder(os.path.join(root, "data"), hu, traffic)
    program.save_params(os.path.join(root, "pretrained", "fold_0", "temp_model"), state)
    depths = [v.shape[0] for v in hu]
    windows = [generate.window_count(d, traffic["window"][2], traffic["overlap"]) for d in depths]
    sample = check_sample(args.seed, depths, traffic["check_volumes"])
    chosen = sorted(profiled_sample(depths, traffic["profiled_volumes"]))
    prediction = os.path.join(root, "prediction")
    paths = {"dir_data": os.path.join(root, "data"),
             "pretrained_dir": os.path.join(root, "pretrained"), "saved_folder": prediction}
    every = program.cli_args(config, traffic, dict(
        paths, split_json=write_split(os.path.join(root, "split.json"), range(len(hu)))), dev)
    warm = program.cli_args(config, traffic, dict(paths, split_json=write_split(
        os.path.join(root, "split_warm.json"), warm_sample(depths, windows, traffic["sw_batch"]))),
        dev)
    traced_args = program.cli_args(config, traffic, dict(
        paths, split_json=write_split(os.path.join(root, "split_traced.json"), chosen)), dev)
    exports = [os.path.join(prediction, f"{i:04d}.npy") for i in range(len(hu))]

    def clear():
        for path in exports:
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)

    cwd = os.getcwd()
    os.chdir(root)  # main writes summary_4_fold.json into the working directory
    try:
        with open(os.path.join(root, "cli.log"), "w") as log:
            with contextlib.redirect_stdout(log):
                program.serve_folder(warm)  # every shape the window will see
                harness.sync(dev)
                clear()
                flush(root)
                setup_s = time.perf_counter() - t0

                calls, missing = [], 0
                start = time.perf_counter()
                while True:
                    a = time.perf_counter()
                    program.serve_folder(every)
                    harness.sync(dev)
                    b = time.perf_counter()
                    calls.append(b - a)
                    missing += sum(not os.path.exists(path) for path in exports)
                    if b - start >= args.seconds:
                        break
                    clear()
                kept = {k: _load(exports[k]) for k in sample}
                clear()

                traced, breakdown, ctx = None, None, None
                if args.trace:
                    ctx = profile(traced_args, len(chosen), sum(windows[k] for k in chosen), dev)
                    clear()
    finally:
        os.chdir(cwd)

    window_s = sum(calls)
    values = {"serve_slices_per_s": sum(depths) * len(calls) / window_s, "setup_s": setup_s}
    if ctx is not None:
        ctx.update(config=config, chips=1, window_s=window_s, windows=sum(windows) * len(calls),
                   peak_bytes=harness.peak(dev))
        values = harness.read_layers(bench, cell["name"], ctx)
        trace = ctx["trace"]
        print(f"portbench: traced one call over {ctx['traced_volumes']} volumes, "
              f"{len(trace.kernels)} kernels, {trace.linked_share() * 100:.1f}% linked to "
              "their launch", flush=True)
        traced = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    peak = harness.peak(dev)

    del ctx
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tally = compare(config, traffic, state, hu, kept, dev)
    print(f"portbench: {cell['name']} served the folder {len(calls)} times in {window_s:.3f} s "
          f"of calls ({', '.join(f'{c:.3f}' for c in calls)}); reference on volumes "
          f"{sorted(kept)}: {tally}", flush=True)
    correct, checks = check.judge(tally, cell["name"])
    return harness.emit(bench, cell["name"], args.trace, values, correct, checks,
                        len(hu) * len(calls), missing, harness.device(dev, 1, peak, traced),
                        breakdown)


def _load(path: str):
    """An exported (D, H, W) mask as (H, W, D), or None where there is none."""
    try:
        return torch.from_numpy(np.load(path).transpose(1, 2, 0).copy())
    except FileNotFoundError:
        return None


def profile(cli_args, volumes: int, windows: int, dev) -> dict:
    """One traced call of ``main`` over the split of the profiled volumes.
    ``main`` has none of the benchmark's spans: the port's runner and model
    spans (``ltu.runner``, ``ltu.model``) take the places of its ``runner``
    and ``forward`` in the trace."""
    with tracing.profiled() as prof:
        harness.sync(dev)
        start_ns = time.time_ns()
        program.serve_folder(cli_args)
        harness.sync(dev)
        end_ns = time.time_ns()
    trace = tracing.Trace(prof, start_ns, end_ns)
    found = program_spans.spans(trace) or {}
    for ours, port in (("runner", "runner"), ("forward", "model")):
        if found.get(port):
            trace.spans[ours] = found[port]
    return {"kind": "serve", "cli": True, "trace": trace, "copy_s": [],
            "traced_volumes": volumes, "traced_windows": windows}


def compare(config, traffic, state, hu, kept, dev) -> dict:
    """The reference's judgement of the kept exports, in f32 with TF32 off,
    over the eval window of the same HU volumes. An export that is absent
    or not of its volume's shape counts in ``bad_exports``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference.build(config, torch.float32, dev)
    ref.load_state_dict(state)
    ref.eval()
    tally = check.ServeTally()
    bad = 0
    one_hot = config["eval_output"] == "one_hot"
    for k in sorted(kept):
        volume = torch.from_numpy(generate.eval_window(hu[k], traffic["eval_window"]))
        volume = volume.movedim(-1, 1).to(dev)
        served_like, soft = blend(ref, volume, traffic, one_hot)
        if kept[k] is None or kept[k].shape != soft.shape:
            bad += 1
            continue
        tally.add(kept[k], served_like, soft, traffic["threshold"])
    values = tally.values() if tally.volumes else {"wrong_side_median": float("inf")}
    return dict(values, bad_exports=bad)
