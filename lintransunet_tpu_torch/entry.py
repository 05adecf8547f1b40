"""The entry points: the counterpart of the JAX package's ``__graft_entry__.py``.

    python3 -m lintransunet_tpu_torch.entry [--dryrun N] [--device cuda]

``entry(device)`` returns ``(fn, (model, x))``: the flagship
``MaskTransUnet``'s bf16 eval forward (the one-hot argmax branch, as JAX's
``model.apply(..., train=False)``) under ``torch.inference_mode`` on a zero
(1, 1, 96, 96, 96) patch, its weights drawn by flax's initialisers from a
seeded generator.

``dryrun_multichip(n, device, dtype)`` runs ``_dryrun_impl``'s sequence on
n ranks, spawned here, each over the flagship topology at 32 x 32 x 4: one
micro-step of the binary data-parallel train step (``step_times`` 2, so it
accumulates and does not update, as JAX's; ``BalanceDiceLoss`` at the
first level; dropout from a generator seeded alike on every rank);
``run_batch`` over n volumes of depths alternating 4 and 6 (each its own
window grid); the 3-class step with criterion weights [10, 1, 2];
``run_batch`` again, then ``keep_largest_connected_component`` on each
volume. Every loss and sum must be finite, and after each step the ranks'
parameters (and the binary step's accumulated gradient) bit-equal, bit
pattern for bit pattern: at this shape the flagship's gradients are
non-finite in most parameters, in the JAX package's too on the same
weights, so NaN must compare equal to itself. Rank 0 prints JAX's four
"ok" lines. The ranks talk over NCCL with one card a rank where the card
count allows, else over gloo (on the CPU, or on one card that the ranks
share; gloo reduces CUDA tensors through the host). A rank that fails
fails the call.
"""

import argparse
import os
import socket
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lintransunet_tpu_torch import engine, parallel
from lintransunet_tpu_torch.cli.common import get_multi_criterion_list
from lintransunet_tpu_torch.cli.postprocess import keep_largest_connected_component
from lintransunet_tpu_torch.losses import binary as binary_losses
from lintransunet_tpu_torch.models import flagship

ENTRY_PATCH = (1, 1, 96, 96, 96)
DRYRUN_PATCH = (32, 32, 4)
DRYRUN_DYNAMIC_WEIGHT = [0.1, 0.2, 0.3, 0.5, 1.0]
STEP_TIMES = 2


def entry(device="cuda"):
    """(fn, (model, x)): the flagship's bf16 eval forward on one 96^3 patch."""
    model = flagship(dtype=torch.bfloat16, device=device).eval()
    x = torch.zeros(ENTRY_PATCH, dtype=torch.bfloat16, device=device)

    def fn(model, patch):
        with torch.inference_mode():
            return model(patch, return_aux=False)

    return fn, (model, x)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _backend(n: int, device: torch.device):
    """(backend, this rank's device for rank r): NCCL with one card a rank,
    else gloo (the CPU, or ranks sharing card 0)."""
    if device.type == "cuda" and torch.cuda.device_count() >= n:
        return "nccl", lambda rank: torch.device("cuda", rank)
    if device.type == "cuda":
        return "gloo", lambda rank: torch.device("cuda", 0)
    return "gloo", lambda rank: device


def dryrun_multichip(n_devices: int, device="cuda", dtype: torch.dtype = torch.bfloat16) -> None:
    """One data-parallel training step over an n-rank mesh, tiny shapes (see
    the module docstring); raises if any rank fails."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: the dry run runs on the card unless "
                           "it is asked for the CPU (device='cpu')")
    backend, _ = _backend(n_devices, device)
    with tempfile.TemporaryDirectory() as workdir:
        try:
            mp.spawn(_rank, args=(n_devices, _free_port(), str(device), dtype, workdir),
                     nprocs=n_devices, join=True)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            raise RuntimeError(f"dryrun_multichip({n_devices}) on {backend} failed: "
                               f"{err}") from err
        with open(os.path.join(workdir, "report.txt")) as f:
            print(f.read(), end="", flush=True)


def _rank(rank: int, n: int, port: int, device: str, dtype: torch.dtype, workdir: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    backend, rank_device = _backend(n, torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=n)
    try:
        mesh = parallel.make_mesh(n, device=rank_device(rank))
        lines = _dryrun_impl(mesh, dtype)
        if rank == 0:
            with open(os.path.join(workdir, "report.txt"), "w") as f:
                f.write("".join(line + "\n" for line in lines))
    finally:
        dist.destroy_process_group()


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(what)


def _same_on_every_rank(mesh, tensors, what: str) -> None:
    """Fail unless every rank's f32 ``tensors`` have rank 0's bits."""
    bits = torch.cat([t.detach().reshape(-1).view(torch.int32) for t in tensors])
    first = bits.clone()
    dist.broadcast(first, src=0)
    differs = torch.tensor([float(not torch.equal(bits, first))], device=mesh.device)
    dist.all_reduce(differs)
    _check(differs.item() == 0, f"the ranks' {what} differ")


def _runner(model, mesh):
    forward = engine.make_eval_forward(model)
    return engine.SlidingWindowRunner(forward, DRYRUN_PATCH, sw_batch_size=1, overlap=0.6,
                                      mode="constant", derive_background=forward.fg_only,
                                      device=mesh.device)


def _dryrun_impl(mesh, dtype: torch.dtype):
    """``__graft_entry__._dryrun_impl`` on this rank; returns rank 0's report
    lines."""
    n = mesh.size
    tag = f"dryrun_multichip({n})"
    rng = np.random.default_rng(0)
    batch = max(n, 2)
    spatial = DRYRUN_PATCH

    def ncdhw(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))

    model = flagship(dtype=dtype, device=mesh.device).train()
    state = engine.create_train_state(model, learning_rate=1e-4, step_times=STEP_TIMES)
    criterions = ([binary_losses.get_criterions(["CrossEntroLoss", "BalanceDiceLoss"])]
                  + [binary_losses.get_criterions(["CrossEntroLoss", "DiceClassLoss"])] * 4)
    step = engine.make_train_step(model, criterions, mesh=mesh)
    images = ncdhw(rng.standard_normal((batch,) + spatial + (1,)).astype(np.float32)).to(dtype)
    labels = torch.from_numpy((rng.random((batch,) + spatial) > 0.8).astype(np.int64))
    images, labels = parallel.shard_batch(mesh, images), parallel.shard_batch(mesh, labels)
    loss, logs = step(state, images, labels, DRYRUN_DYNAMIC_WEIGHT,
                      torch.Generator(device=mesh.device).manual_seed(1))
    loss = loss.item()
    _check(np.isfinite(loss) and all(np.isfinite(v.item()) for v in logs.values()),
           f"non-finite loss {loss} or logs {logs}")
    _same_on_every_rank(mesh, list(model.parameters()) + state.acc_grads,
                        "parameters and accumulated gradients after the binary step")
    lines = [f"{tag} train ok: loss={loss:.5f}"]

    volumes = [ncdhw(rng.standard_normal((1,) + spatial[:2] + (4 + 2 * (i % 2), 1))
                     .astype(np.float32)).to(dtype) for i in range(n)]
    outs = _runner(model, mesh).run_batch(volumes, mesh=mesh)
    _check([tuple(o.shape) for o in outs] == [(1, 2) + tuple(v.shape[2:]) for v in volumes],
           f"run_batch shapes {[tuple(o.shape) for o in outs]}")
    total = float(sum(o.float().sum().item() for o in outs))
    _check(np.isfinite(total), f"non-finite eval blend {total}")
    lines.append(f"{tag} binary ok: loss={loss:.5f} eval_sum={total:.1f}")

    model3 = flagship(seed=2, dim_output=3, dtype=dtype, device=mesh.device).train()
    state3 = engine.create_train_state(model3, learning_rate=1e-4)
    mc_criterions, _ = get_multi_criterion_list(
        5, ["CrossEntroLoss", "DiceClassLoss", "DiceClassLoss2"])
    step3 = engine.make_train_step(model3, mc_criterions, criterion_weight=[10.0, 1.0, 2.0],
                                   num_classes=3, mesh=mesh)
    labels3 = parallel.shard_batch(
        mesh, torch.from_numpy(rng.integers(0, 3, (batch,) + spatial).astype(np.int64)))
    loss3, _ = step3(state3, images, labels3, DRYRUN_DYNAMIC_WEIGHT,
                     torch.Generator(device=mesh.device).manual_seed(3))
    loss3 = loss3.item()
    _check(np.isfinite(loss3), f"non-finite multi-class loss {loss3}")
    _same_on_every_rank(mesh, list(model3.parameters()),
                        "parameters after the multi-class step")
    lines.append(f"{tag} multi-class train ok: loss={loss3:.5f}")

    kept = 0.0
    for out in _runner(model3, mesh).run_batch(volumes, mesh=mesh):
        onehot = torch.round(out[0]).float().cpu().numpy()
        hard = keep_largest_connected_component(onehot, applied_labels=(1, 2),
                                                independent=False, connectivity=3)
        _check(bool(np.isfinite(hard).all()), "non-finite connected-component output")
        kept += float(hard[1:].sum())
    lines.append(f"{tag} ok: loss={loss:.5f} mc_loss={loss3:.5f} eval_sum={total:.1f} "
                 f"mc_kept={kept:.0f}")
    return lines


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dryrun", type=int, default=None, metavar="N",
                        help="run dryrun_multichip(N) instead of the entry forward")
    parser.add_argument("--device", default="cuda", help="the card by default; cpu for a CPU run")
    args = parser.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return
    fn, (model, x) = entry(args.device)
    out = fn(model, x)
    print("entry forward:", tuple(out.shape), out.dtype, flush=True)


if __name__ == "__main__":
    main()
