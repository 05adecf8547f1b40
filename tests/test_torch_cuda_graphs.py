"""The train step's CUDA graphs against the same micro-steps run eagerly.

Needs an NVIDIA GPU; skips without one (the two-card test without two). On a
machine with the card and no jax (this file imports none), run it without
the repo's jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda_graphs.py

Every comparison runs under ``chip_smoke.deterministic()`` and asks for the
same bits: a replay launches the kernels the eager micro-step launches, on
the same inputs, weights and dropout stream. The eager side composes the
micro-step from the step's public pieces (``step.loss_fn``, the backward,
``parallel.all_reduce_mean`` under a mesh, ``engine.apply_gradients``), as
the step's CPU path runs it.

The model is a small bf16 ``MaskTransUnet`` whose level-3 ROI bridge and
bottleneck run 256-channel positional encodings, so that its backward goes
through the depthwise weight-gradient kernel too, and whose 3x3x3
convolutions of at most 8 outputs (the final block, the level 0-1 mask
heads, the 8-wide conv blocks) go through the narrow-output convolution
kernel; the first comparison also runs on the flagship at its published
widths on the 512 x 512 x 32 training patch.
"""

import gc
import os
import socket
import time

import pytest
import torch
import torch.multiprocessing as mp

from lintransunet_tpu_torch import engine, parallel
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.engine.train import _with_grads
from lintransunet_tpu_torch.models import FLAGSHIP
from lintransunet_tpu_torch.ops import conv_narrow, conv_wgrad
from lintransunet_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

# The models the comparisons build: widths, (H, W, D) of a patch, patches a
# micro-batch, the label box, and the convolutions of a forward that route
# to conv_narrow
SIZES = {
    "small": (dict(num_layers=(8, 16, 32, 64, 256), roi_size_list=(16, 12, 8, 6, 4),
                   is_roi_list=(False, True, True, True, True), dim_input=1, dim_output=2,
                   n_layers=2, dropout=0.3),
              (64, 64, 8), 2, (slice(20, 44), slice(24, 40), slice(2, 6)), 7),
    "flagship": (dict(FLAGSHIP, dropout=0.3), (512, 512, 32), 1,
                 (slice(200, 320), slice(220, 300), slice(8, 24)), 5),
}
WEIGHTS = [0.15, 0.25, 0.4, 0.5, 1.0]
DP_SECONDS = 150  # a collective that waits on a rank that is gone never returns


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _deterministic():
    import chip_smoke

    return chip_smoke.deterministic()


def _model(device, size):
    from lintransunet_tpu_torch.models import MaskTransUnet, init_random_

    model = MaskTransUnet(**SIZES[size][0], dtype=torch.bfloat16, device=device)
    init_random_(model, torch.Generator(device="cpu").manual_seed(1))
    return model


def _batches(device, count, batch=None, seed=0, size="small"):
    _, spatial, patches, box, _ = SIZES[size]
    batch = patches if batch is None else batch
    g = torch.Generator(device="cpu").manual_seed(seed)
    labels = torch.zeros((batch,) + spatial, dtype=torch.long)
    labels[(slice(None),) + box] = 1
    return ([torch.randn((batch, 1) + spatial, generator=g).to(device) for _ in range(count)],
            labels.to(device))


def _setup(device, step_times=2, mesh=None, size="small"):
    model = _model(device, size)
    criterions, _ = get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])
    state = engine.create_train_state(model, 1e-4, step_times=step_times)
    return model, state, engine.make_train_step(model, criterions, mesh=mesh)


def _eager(step, state, images, labels, weights, generator, mesh=None):
    """The micro-step as the step's CPU path runs it."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    loss, logs = step.loss_fn(images, labels, weights, generator)
    loss.backward()
    loss = loss.detach()
    if mesh is not None:
        values = [loss.float()] + [v.detach().float() for v in logs.values()]
        parallel.all_reduce_mean(mesh, [p.grad for p in _with_grads(state.model)] + values)
        loss = values[0]
    engine.apply_gradients(state)
    return loss


def _same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(p.grad, q.grad), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for key in ("exp_avg", "exp_avg_sq"):  # no state yet: AdamW's zeros
            assert torch.equal(sa.get(key, torch.zeros_like(p)),
                               sb.get(key, torch.zeros_like(q))), (name, key)
    assert (a.step, a.mini_step, a.gradient_step) == (b.step, b.mini_step, b.gradient_step)


@pytest.mark.parametrize("size", ["small", "flagship"])
def test_graphed_micro_steps_match_eager(cuda, size):
    """Four micro-steps of step_times 2 (both phases, twice): the same bits
    as eager, one graph a phase, every micro-step a replay, the routed
    convolutions through the kernels (conv_narrow's calls a forward in each
    pass through Python), and the returned losses distinct (clones, not the
    graph's buffer)."""
    images, labels = _batches(cuda, 4, size=size)
    with _deterministic():
        _, graphed, step = _setup(cuda, size=size)
        _, eager, eager_step = _setup(cuda, size=size)
        gens = [torch.Generator(device=cuda).manual_seed(3) for _ in range(2)]
        replayed, launches = profiling.counts["step.replayed"], conv_wgrad.depthwise_weight_grad.launches
        narrow, passes = conv_narrow.conv_narrow.launches, engine.python_passes()
        losses = []
        for x in images:
            loss, logs = step(graphed, x, labels, torch.tensor(WEIGHTS, device=cuda), gens[0])
            want = _eager(eager_step, eager, x, labels, WEIGHTS, gens[1])
            assert torch.equal(loss, want)
            losses.append(loss)
            _same_state(graphed, eager)
        torch.cuda.synchronize()
    assert profiling.counts["step.replayed"] == replayed + 4
    assert len(step.graphs.captured) == 2
    assert conv_wgrad.depthwise_weight_grad.launches > launches
    # the graphed side's passes through Python and the eager side's four forwards
    forwards = engine.python_passes() - passes + len(images)
    *_, narrow_a_forward = SIZES[size]
    assert conv_narrow.conv_narrow.launches - narrow == narrow_a_forward * forwards
    assert len({float(v) for v in losses}) == 4
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


def test_set_learning_rate_reaches_a_captured_update(cuda):
    """A new rate set after both phases are captured changes the next
    update as it changes the eager one's."""
    images, labels = _batches(cuda, 4, seed=1)
    with _deterministic():
        _, graphed, step = _setup(cuda)
        _, eager, eager_step = _setup(cuda)
        _, unchanged, unchanged_step = _setup(cuda)
        gens = [torch.Generator(device=cuda).manual_seed(4) for _ in range(3)]
        for i, x in enumerate(images):
            if i == 2:
                engine.set_learning_rate(graphed, 1e-3)
                engine.set_learning_rate(eager, 1e-3)
            step(graphed, x, labels, WEIGHTS, gens[0])
            _eager(eager_step, eager, x, labels, WEIGHTS, gens[1])
            unchanged_step(unchanged, x, labels, WEIGHTS, gens[2])
        torch.cuda.synchronize()
    _same_state(graphed, eager)
    assert engine.get_learning_rate(graphed) == pytest.approx(1e-3)
    assert any(not torch.equal(p, q) for p, q in zip(graphed.model.parameters(),
                                                      unchanged.model.parameters()))


def test_checkpoint_round_trip_keeps_the_captured_step(cuda, tmp_path):
    """A train state saved with the capturable AdamW and restored, into the
    same state (whose graphs are captured) and into a fresh one, continues
    to the same bits; the restore writes into the tensors the graphs read."""
    images, labels = _batches(cuda, 4, seed=2)
    path = str(tmp_path / "train_state")
    with _deterministic():
        model, state, step = _setup(cuda)
        gen = torch.Generator(device=cuda).manual_seed(5)
        for x in images[:2]:
            step(state, x, labels, WEIGHTS, gen)
        engine.save_train_state(path, state, aux={"epoch": 1})
        resume = gen.get_state()
        for x in images[2:]:
            step(state, x, labels, WEIGHTS, gen)
        after = [p.detach().clone() for p in model.parameters()]
        held = [state.optimizer.state[p]["exp_avg"] for p in model.parameters()]
        lr = state.optimizer.param_groups[0]["lr"]

        _, aux = engine.restore_train_state(path, state)
        assert aux == {"epoch": 1} and (state.step, state.mini_step) == (2, 0)
        assert all(state.optimizer.state[p]["exp_avg"] is h
                   for p, h in zip(model.parameters(), held))
        assert state.optimizer.param_groups[0]["lr"] is lr and torch.is_tensor(lr)
        gen.set_state(resume)
        for x in images[2:]:
            step(state, x, labels, WEIGHTS, gen)
        assert all(torch.equal(p, a) for p, a in zip(model.parameters(), after))

        fresh_model, fresh, fresh_step = _setup(cuda)
        engine.restore_train_state(path, fresh)
        gen.set_state(resume)
        for x in images[2:]:
            fresh_step(fresh, x, labels, WEIGHTS, gen)
        torch.cuda.synchronize()
    assert all(torch.equal(p, a) for p, a in zip(fresh_model.parameters(), after))


def test_a_second_batch_shape_captures_its_own_graph(cuda):
    """A smaller last batch captures a graph of its own and runs as the
    eager micro-step does."""
    (x2,), labels2 = _batches(cuda, 1, batch=2, seed=3)
    (x1,), labels1 = _batches(cuda, 1, batch=1, seed=4)
    with _deterministic():
        _, graphed, step = _setup(cuda, step_times=1)
        _, eager, eager_step = _setup(cuda, step_times=1)
        gens = [torch.Generator(device=cuda).manual_seed(6) for _ in range(2)]
        for x, labels in ((x2, labels2), (x1, labels1)):
            loss, _ = step(graphed, x, labels, WEIGHTS, gens[0])
            assert torch.equal(loss, _eager(eager_step, eager, x, labels, WEIGHTS, gens[1]))
        torch.cuda.synchronize()
    assert len(step.graphs.captured) == 2
    _same_state(graphed, eager)


def _dp_compare(rank, world, out, device):
    mesh = parallel.make_mesh(world, device=device)
    images, labels = _batches(device, 4, seed=7)
    shard = slice(rank, rank + 1)
    with open(os.path.join(out, f"progress{rank}"), "a", buffering=1) as log, _deterministic():
        _, graphed, step = _setup(device, mesh=mesh)
        _, eager, eager_step = _setup(device, mesh=mesh)
        gens = [torch.Generator(device=device).manual_seed(8) for _ in range(2)]
        for i, x in enumerate(images):
            loss, _ = step(graphed, x[shard], labels[shard], WEIGHTS, gens[0])
            log.write(f"graphed micro-step {i}\n")
            want = _eager(eager_step, eager, x[shard], labels[shard], WEIGHTS, gens[1], mesh)
            torch.cuda.synchronize()
            log.write(f"eager micro-step {i}\n")
            assert torch.equal(loss, want)
        _same_state(graphed, eager)
    # NCCL's all-reduce inside the one graph; gloo's between two
    graphs = {len(c.graphs) for c in step.graphs.captured.values()}
    assert graphs == ({1} if torch.distributed.get_backend() == "nccl" else {2})
    with open(os.path.join(out, f"rank{rank}"), "w") as f:
        f.write("ok")


def _dp_worker(rank, world, port, out, backend):
    """One rank: on its own card over NCCL, on card 0 beside the other over
    gloo."""
    device = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(device)
    extra = {"device_id": device} if backend == "nccl" else {}
    torch.distributed.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                         rank=rank, world_size=world, **extra)
    try:
        _dp_compare(rank, world, out, device)
        gc.collect()  # the step's graphs go before the communicator they captured
        torch.cuda.synchronize()
    finally:
        torch.distributed.destroy_process_group()


def _two_ranks(tmp_path, backend):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ranks = mp.spawn(_dp_worker, args=(2, port, str(tmp_path), backend), nprocs=2, join=False)
    deadline = time.monotonic() + DP_SECONDS
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            progress = {name: (tmp_path / name).read_text() for name in os.listdir(tmp_path)}
            pytest.fail(f"the two ranks did not finish in {DP_SECONDS} s: {progress}")
    assert {"rank0", "rank1"} <= set(os.listdir(tmp_path))


def test_graphed_data_parallel_step_matches_eager(cuda, tmp_path):
    """Two cards over NCCL: the graphed DP micro-step (its all-reduce
    captured in the graph) gives the eager DP micro-step's bits on each
    rank."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    _two_ranks(tmp_path, "nccl")


def test_graphed_gloo_step_matches_eager(cuda, tmp_path):
    """Two gloo ranks sharing one card: gloo's all-reduce waits on the host
    and cannot be captured, so each micro-step replays two graphs around an
    eager all-reduce, and gives the eager DP micro-step's bits."""
    _two_ranks(tmp_path, "gloo")


def test_graphed_recompute_matches_eager(cuda, monkeypatch):
    """Under the "attn" recompute policy (``blocks.REMAT``) the capture holds
    the checkpointed layers, whose recompute takes back the forward's
    dropout masks: four graphed micro-steps give the eager ones' bits and
    leave the generator where the eager ones do."""
    from lintransunet_tpu_torch.models import blocks

    monkeypatch.setattr(blocks, "REMAT", "attn")
    images, labels = _batches(cuda, 4, seed=9)
    with _deterministic():
        _, graphed, step = _setup(cuda)
        _, eager, eager_step = _setup(cuda)
        gens = [torch.Generator(device=cuda).manual_seed(10) for _ in range(2)]
        for x in images:
            loss, _ = step(graphed, x, labels, WEIGHTS, gens[0])
            assert torch.equal(loss, _eager(eager_step, eager, x, labels, WEIGHTS, gens[1]))
        torch.cuda.synchronize()
    _same_state(graphed, eager)
    assert len(step.graphs.captured) == 2
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
