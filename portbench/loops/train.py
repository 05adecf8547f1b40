"""The training micro-step, closed loop: the port's ``make_train_step`` at
the mix's recipe, on one card or data-parallel over ``ranks`` cards (one
process a card, NCCL, a micro-batch of ``batch`` a rank, every rank's
dropout generator seeded alike). Set-up builds the step once and drives it
through its first ``check_steps`` micro-steps, which the reference follows
afterwards; the window then runs the same step on for the run's seconds."""

import gc
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from portbench import check, generate, harness, program
from portbench import trace as tracing
from portbench.reference import model as reference
from portbench.reference.train import Trainer

STOP_EVERY = 4  # micro-steps between the ranks' agreement on the window's end


def run(args, bench: dict, cell: dict, config: dict, traffic: dict, t0: float,
        device="cuda") -> int:
    ranks = traffic["ranks"]
    wall0 = time.time() - (time.perf_counter() - t0)
    if ranks == 1:
        return harness.emit(**rank_main(0, 1, args, bench, cell, config, traffic, wall0, device))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(r, ranks, port, args, bench, cell, config,
                                                   traffic, wall0, device))
             for r in range(ranks)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    codes = [p.exitcode for p in procs]
    return codes[0] if all(c == 0 for c in codes[1:]) else (codes[0] or 1)


def _rank_entry(rank, ranks, port, args, bench, cell, config, traffic, wall0, device):
    """One rank's process; rank 0 prints the result once the group is down,
    so that its compared numbers are the last lines on standard error, and
    its exit code is the run's."""
    torch.set_num_threads(2)
    url = f"tcp://localhost:{port}"
    if device == "cuda":
        dist.init_process_group("nccl", init_method=url, rank=rank, world_size=ranks,
                                device_id=torch.device("cuda", rank))
    else:  # a CPU rehearsal
        dist.init_process_group("gloo", init_method=url, rank=rank, world_size=ranks)
    try:
        result = rank_main(rank, ranks, args, bench, cell, config, traffic, wall0, device)
    finally:
        dist.destroy_process_group()
    sys.exit(harness.emit(**result) if rank == 0 else 0)


def rank_main(rank, ranks, args, bench, cell, config, traffic, wall0, device="cuda"):
    """This rank's part of the run; rank 0's result (``harness.emit``'s
    arguments), None on the others."""
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = program.make_mesh(ranks, dev) if ranks > 1 else None
    state = program.weights(config, generate.substream(args.seed, 0), dev)
    model = program.build_model(config, state, dev).train()
    if mesh is not None:
        program.replicate(mesh, model)
    train_state, step = program.train_step(model, traffic, mesh)

    batch, pool = traffic["batch"], traffic["pool_batches"]
    data = generate.patches(args.seed, traffic, pool * batch * ranks, dev)
    images, labels = data["images"], data["label"].expand(batch * ranks, *traffic["patch"])
    level_weights = torch.tensor(traffic["level_weights"], device=dev)
    generator = torch.Generator(device=dev).manual_seed(generate.substream(args.seed, 5))

    def rows(i, r=rank):
        first = (i % pool) * batch * ranks + r * batch
        return slice(first, first + batch)

    def micro_step(i):
        return step(train_state, images[rows(i)], labels[:batch], level_weights, generator)[0]

    checked = traffic["check_steps"]
    losses, grads = [], None
    for i in range(checked):
        losses.append(micro_step(i))
        if train_state.gradient_step == 1 and grads is None:
            grads = check.first_gradients(model.named_parameters(), train_state.optimizer)
    if grads is None:  # no update in the checked micro-steps: the state holds no gradient
        grads = check.first_gradients(model.named_parameters(), train_state.optimizer)
    program_side = {"losses": [float(x) for x in losses], "grads": grads,
                    "changes": {n: float((p.detach() - state[n]).norm())
                                for n, p in model.named_parameters()}}
    harness.sync(dev)
    setup_s = time.time() - wall0

    bad = torch.zeros((), device=dev)
    n = 0
    start = time.perf_counter()
    while True:
        bad += ~torch.isfinite(micro_step(checked + n))
        n += 1
        over = time.perf_counter() - start >= args.seconds
        if mesh is None:
            stop = over
        elif n % STOP_EVERY == 0:
            flag = torch.tensor([float(over)], device=dev)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            stop = bool(flag.item())
        else:
            stop = False
        if stop:
            break
    harness.sync(dev)
    window_s = time.perf_counter() - start
    failed = int(bad.item())
    values = {"train_patches_per_s": n * batch * ranks / window_s, "setup_s": setup_s}

    traced, breakdown = None, None
    if args.trace:
        ctx = profile(model, micro_step, checked + n, traffic, dev)
        ctx.update(config=config, chips=ranks, window_s=window_s, steps=n,
                   peak_bytes=harness.peak(dev))
        layer = harness.read_layers(bench, cell["name"], ctx)
        trace = ctx["trace"]
        mine = {"layer": layer, "busy_s": trace.busy_s(), "window_s": trace.window_s}
        every = [mine] * ranks
        if mesh is not None:
            every = [None] * ranks
            dist.all_gather_object(every, mine)
        values = harness.worst(bench, [r["layer"] for r in every])
        traced = {"busy_s": sum(r["busy_s"] for r in every) / ranks,
                  "window_s": trace.window_s}
        breakdown = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    peak = harness.peak(dev)
    if mesh is not None:
        most = torch.tensor([float(peak)], device=dev)
        dist.all_reduce(most, op=dist.ReduceOp.MAX)
        peak = int(most.item())

    del model, train_state, step, losses, micro_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    result = None
    if rank == 0:
        reference_side = follow(config, traffic, state, images, labels, rows, level_weights,
                                generate.substream(args.seed, 5), ranks, dev)
        values_checked = check.train_values(program_side, reference_side)
        print(f"portbench: {cell['name']} {n} micro-steps of {batch * ranks} patches in "
              f"{window_s:.3f} s; program losses {program_side['losses']}, reference "
              f"{reference_side['losses']}; {values_checked}", flush=True)
        correct, checks = check.judge(values_checked, cell["name"])
        result = dict(bench=bench, cell=cell["name"], trace=args.trace, values=values,
                      correct=correct, checks=checks, attempted=n, failed=failed,
                      dev=harness.device(dev, ranks, peak, traced), breakdown=breakdown)
    if mesh is not None:
        dist.barrier()
    return result


def profile(model, micro_step, first: int, traffic: dict, dev) -> dict:
    """A traced stretch of ``profiled_steps`` micro-steps, each in a
    ``step`` span, with the model's forwards in ``forward`` spans."""
    hooks = tracing.ForwardSpans(model)
    steps = traffic["profiled_steps"]
    try:
        with tracing.profiled() as prof:
            harness.sync(dev)
            start_ns = time.time_ns()
            for i in range(steps):
                with tracing.span("step"):
                    micro_step(first + i)
            harness.sync(dev)
            end_ns = time.time_ns()
    finally:
        hooks.remove()
    trace = tracing.Trace(prof, start_ns, end_ns)
    print(f"portbench: traced {steps} micro-steps, {len(trace.kernels)} kernels, "
          f"{trace.linked_share() * 100:.1f}% linked to their launch", flush=True)
    return {"kind": "train", "trace": trace, "traced_steps": steps}


def follow(config, traffic, state, images, labels, rows, level_weights, dropout_seed,
           ranks, dev) -> dict:
    """The reference's first ``check_steps`` micro-steps on the global
    batches, in f32 with TF32 off, a rank's rows a block."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = reference.build(config, torch.float32, dev)
    model.load_state_dict(state)
    trainer = Trainer(model, traffic["learning_rate"], traffic["step_times"])
    generator = torch.Generator(device=dev).manual_seed(dropout_seed)
    losses, grads = [], None
    for i in range(traffic["check_steps"]):
        global_rows = torch.cat([torch.arange(rows(i, r).start, rows(i, r).stop)
                                 for r in range(ranks)]).to(dev)
        losses.append(float(trainer.step(images[global_rows], labels,
                                         level_weights, generator, blocks=ranks)))
        if grads is None and trainer.optimizer.state:
            grads = check.first_gradients(model.named_parameters(), trainer.optimizer)
    changes = {n: float((p.detach() - state[n]).norm()) for n, p in model.named_parameters()}
    return {"losses": losses, "grads": grads, "changes": changes}
