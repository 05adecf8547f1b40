"""What the data-parallel step's global-batch dropout masks cost and how far
its f32 gradients may move, on one CUDA card.

    python3 tools/diag_dp_dropout.py

Two readings, each beside the card's name and power limit:

* ``floor``: ``chip_smoke.py`` 13b's joined batch of 2 (the f32 flagship,
  TF32 off, under ``chip_smoke.deterministic()``) at dropout 0 and 0.3:
  the joined step rerun, the joined step with the weights moved by 1e-7
  relative (the rounding floor), and the mean of the two per-sample steps,
  each drawing its rows of the global masks (what the DP step sums), each
  against the joined step; then the largest |gradient| of the worst
  parameter joined and per sample (a gradient that cancels between the
  samples moves most with rounding);
* ``cost``: the bf16 flagship step on phase 7's patch with the shard of
  rank 0 of 1 and of rank 0 of 4 (each mask drawn at 4 samples' shape, one
  row kept; the all-reduce replaced by nothing), turns 1, 4, 4, 1, each 2
  warm steps then STEPS back to back with one synchronise, and the peak
  memory of one step.
"""

import sys
import time
import types
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from lintransunet_tpu_torch import engine, kernels, parallel  # noqa: E402
from lintransunet_tpu_torch.models import MaskTransUnet, init_random_  # noqa: E402

STEPS = 5
WORST = "encode.block_list_3.conv2.weight"


def grads_of(images, labels, criterions, dropout, jitter=0.0, shard=None):
    """(loss, {name: gradient}) of the f32 flagship's loss on this batch, the
    masks drawn under ``shard`` (rank, size) if given."""
    model = cs.f32_flagship(dropout).train()
    if jitter:
        cs.move_weights_(model, jitter)
    mesh = None if shard is None else types.SimpleNamespace(rank=shard[0], size=shard[1])
    step = engine.make_train_step(model, criterions, mesh=mesh)
    loss, _ = step.loss_fn(images, labels, cs.DYNAMIC_WEIGHT, cs.dropout_generator())
    loss.backward()
    out = loss.item(), {n: p.grad.float().clone() for n, p in model.named_parameters()}
    del model, step
    torch.cuda.empty_cache()
    return out


def floor():
    images, labels, criterions = cs.dp_batch()
    for dropout in (0.0, cs.DP_DROPOUT):
        with cs.deterministic():
            joined = grads_of(images, labels, criterions, dropout)
            tag = f"[floor] dropout {dropout:g}"
            cs.compare_steps(f"{tag}, the joined step rerun",
                             grads_of(images, labels, criterions, dropout), joined)
            cs.compare_steps(f"{tag}, the weights moved by 1e-7 (the floor)",
                             grads_of(images, labels, criterions, dropout, 1e-7), joined)
            parts = [grads_of(images[r:r + 1], labels[r:r + 1], criterions, dropout,
                              shard=(r, 2)) for r in range(2)]
            mean = ((parts[0][0] + parts[1][0]) / 2,
                    {n: (parts[0][1][n] + parts[1][1][n]) / 2 for n in joined[1]})
            cs.compare_steps(f"{tag}, the mean of the per-sample steps", mean, joined)
        print(f"{tag}: {WORST} max |gradient| joined {joined[1][WORST].abs().max().item():.4e}, "
              f"per sample {[f'{p[1][WORST].abs().max().item():.4e}' for p in parts]}",
              flush=True)


def step_ms(size):
    """(ms a step, peak GiB) of the bf16 flagship's step with rank 0 of
    ``size``'s shard."""
    model = MaskTransUnet(**cs.FLAGSHIP, dtype=torch.bfloat16, dropout=0.3)
    init_random_(model, torch.Generator(device="cpu").manual_seed(cs.SEED))
    model.train()
    images, labels, criterions = cs.train_inputs()
    state = engine.create_train_state(model, learning_rate=1e-4)
    step = engine.make_train_step(model, criterions,
                                  mesh=types.SimpleNamespace(rank=0, size=size))
    gen = cs.dropout_generator()
    for _ in range(2):
        step(state, images, labels, cs.DYNAMIC_WEIGHT, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(state, images, labels, cs.DYNAMIC_WEIGHT, gen)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step(state, images, labels, cs.DYNAMIC_WEIGHT, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / STEPS * 1e3
    del model, state, step
    torch.cuda.empty_cache()
    return ms, peak


def cost():
    reduce = parallel.all_reduce_mean
    parallel.all_reduce_mean = lambda mesh, tensors: tensors  # one process, no group
    try:
        for size in (1, 4, 4, 1):
            ms, peak = step_ms(size)
            print(f"[cost] bf16 step, shard (0, {size}): {ms:.2f} ms a step (mean of {STEPS}), "
                  f"peak {peak:.2f} GiB", flush=True)
    finally:
        parallel.all_reduce_mean = reduce


def main():
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool runs only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.load("linear_attention")
    print(f"card {cs.card()}; torch {torch.__version__}", flush=True)
    floor()
    cost()


if __name__ == "__main__":
    main()
