"""The port's data parallelism (``lintransunet_tpu_torch.parallel``) on two
CPU ranks over gloo, against the JAX package and against the port's own
single-process step, in f32.

The ranks are spawned (``tests/torch_port_helpers.py``: ``dp_worker``,
``cli_worker``) over a file store, a few seconds each here.

* The DP train step of the tiny model (``DP_TINY``: no ROI level, dropout
  0) with a 2-sample global batch, one sample a rank, for every criterion
  of the binary (16) and multi-class (20) ``Loss_Dict``: both ranks report
  the global loss and logs and hold bit-equal parameters after the step;
  the loss and every gradient equal the port's single-process step on the
  joined batch and JAX's gradient of the joined batch's loss (loss rtol
  1e-6 and 1e-5, gradients 1e-4 of their max with the vanishing-gradient
  rule of ``tests/test_torch_train.py``: f32 sums in another order; the
  DP step averages two per-sample gradients where the joined step's convs
  sum over both samples, up to 1.8e-5 of the max measured here; the
  LocalizationLoss cases' gradients are all 0, their sigmoids saturating at
  this size as at any real one, and are held to 0). JAX's
  gradients come from ``jax.vjp`` of the model's train forward, pulled back
  from each criterion's deep-supervision loss (the chain rule of
  ``make_train_step``'s ``value_and_grad``; one compile serves the 36
  criteria), and for the CLI's criterions from ``make_train_step`` itself.
  Dropout is 0 in these cases: JAX's masks are other random numbers.
* ``step_times`` 2: the ranks accumulate the group-averaged gradients as
  ``optax.MultiSteps`` does.
* Dropout under a mesh: the ranks, seeded alike, draw the rows of the
  mask that one process draws for the joined batch (element and channel
  masks; without a mesh the masks are the draws they always were), and the
  DP step at dropout 0.3 equals the port's single-process step on the
  joined batch (the loss within 1e-6 relative, gradients by the 1e-4 rule,
  the ranks' parameters bit-equal), as JAX's SPMD step draws the global
  batch's masks once.
* ``SolidBlock``'s BatchNorm under a mesh takes the global batch's
  statistics: two ranks' training forward and backward on their rows equal
  one process on the joined batch (outputs, the input's gradient, the
  parameters' gradients summed over the ranks, the running statistics) and
  flax's ``BatchNorm`` on the joined batch (``jax.vjp``), atol 1e-5.
* ``run_batch`` and ``batched_predictions`` with and without a mesh equal
  JAX's ``run_batch`` on volumes of depths 7, 10 and 12 (7 below the
  window's 8), bit for bit between the ranks and the single process.
* The sharded loader, the collectives, ``make_mesh``'s refusal to run
  without a group, and ``train3d`` then ``inference_embed_attn`` on two
  ranks: one writer, bit-equal parameters, and one rank's summary.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_port_helpers as helpers
from lintransunet_tpu import engine as jax_engine
from lintransunet_tpu.cli.common import get_criterion_list as jax_criterion_list
from lintransunet_tpu.losses import binary as jax_binary
from lintransunet_tpu.losses import multiclass as jax_multiclass
from lintransunet_tpu.models import MaskTransUnet as JaxMaskTransUnet
from lintransunet_tpu.models import blocks as jax_blocks
from lintransunet_tpu_torch import engine, parallel
from lintransunet_tpu_torch.cli import inference_embed_attn
from lintransunet_tpu_torch.cli.common import get_criterion_list
from lintransunet_tpu_torch.compat import from_flax, to_ncdhw
from lintransunet_tpu_torch.data import DataLoader
from lintransunet_tpu_torch.engine.sliding_window import SlidingWindowRunner
from lintransunet_tpu_torch.losses import binary, multiclass
from lintransunet_tpu_torch.models import MaskTransUnet, SolidBlock
from lintransunet_tpu_torch.models import blocks
from torch_port_helpers import DP_MASK_SHAPE, DP_TINY, random_params, t, worst_grad_error

torch.set_num_threads(2)

SEED = 3
PATCH = (2, 16, 16, 8)  # the joined batch (N, H, W, D): one sample a rank
LR = 1e-3
DYNAMIC_WEIGHT = [0.5, 1.0]
CLI_CRITERIA = ("CrossEntroLoss", "DiceClassLoss")
KINDS = {"binary": (2, jax_binary, binary), "multi": (3, jax_multiclass, multiclass)}
# key: (kind, criteria, step_times, dropout)
CASES = {f"{kind}/{name}": (kind, (name,), 1, 0.0)
         for kind, (_, _, module) in KINDS.items() for name in module.Loss_Dict}
CASES["cli"] = ("binary", CLI_CRITERIA, 1, 0.0)  # train3d's criterions at every level
CASES["accumulate"] = ("binary", CLI_CRITERIA, 2, 0.0)
CASES["dropout"] = ("binary", CLI_CRITERIA, 1, 0.3)
DROPOUT_SEED = 7  # every rank's dropout generator, and the joined step's
ROI = (8, 8, 8)
DEPTHS = (7, 10, 12)
SOLID_SHAPE = (4, 5, 7)  # SolidBlock's joined batch: two rows of (5, 7) a rank


def _labels(rng, kind):
    lbl = np.zeros(PATCH, np.int32)
    lbl[:, 4:12, 5:13, 2:6] = 1
    if kind == "multi":
        lbl[:, 8:12, 9:13, 3:7] = 2
    # some label noise, so that every sample differs
    flip = rng.random(PATCH) < 0.05
    return np.where(flip, rng.integers(0, KINDS[kind][0], PATCH), lbl).astype(np.int32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(SEED)
    out = {"params": {}, "batches": {}}
    for kind, (classes, _, _) in KINDS.items():
        jmodel = JaxMaskTransUnet(**DP_TINY, dim_output=classes)
        x = rng.standard_normal(PATCH + (1,)).astype(np.float32)
        out["params"][kind] = random_params(jmodel, jnp.asarray(x), train=False, seed=SEED)
        out["batches"][kind] = [(x, _labels(rng, kind))] + [
            (rng.standard_normal(PATCH + (1,)).astype(np.float32), _labels(rng, kind))]
    out["volumes"] = [rng.standard_normal((1, 8, 8, d, 1)).astype(np.float32)
                      for d in DEPTHS]
    x = rng.standard_normal(SOLID_SHAPE).astype(np.float32)
    out["solid"] = {"x": x, "cotangent": rng.standard_normal(SOLID_SHAPE[:-1] + (1,))
                    .astype(np.float32),
                    "params": random_params(jax_blocks.SolidBlock(SOLID_SHAPE[-1]),
                                            jnp.asarray(x), seed=SEED, scale=0.5)}
    return out


def _solid_spec(inputs):
    solid = inputs["solid"]
    return {"x": t(solid["x"]), "cotangent": t(solid["cotangent"]),
            "state": from_flax(solid["params"], {"solid_layer_1": {
                "mean": np.zeros(12, np.float32), "var": np.ones(12, np.float32)}})}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Both ranks' results of ``dp_worker`` over ``inputs``."""
    workdir = str(tmp_path_factory.mktemp("dp"))
    spec = {"cases": CASES, "lr": LR, "dynamic_weight": DYNAMIC_WEIGHT, "roi": ROI,
            "dropout_seed": DROPOUT_SEED,
            "params": {k: from_flax(p) for k, p in inputs["params"].items()},
            "batches": {k: [(t(to_ncdhw(x)), t(y)) for x, y in b]
                        for k, b in inputs["batches"].items()},
            "volumes": [t(to_ncdhw(v)) for v in inputs["volumes"]],
            "solid": _solid_spec(inputs)}
    torch.save(spec, os.path.join(workdir, "spec.pt"))
    mp.spawn(helpers.dp_worker, args=(2, os.path.join(workdir, "store"), workdir),
             nprocs=2, join=True)
    return [torch.load(os.path.join(workdir, f"rank{r}.pt")) for r in range(2)]


@pytest.fixture(scope="module")
def jax_forward(inputs):
    """{(kind, batch): (train outputs, pullback)}: ``jax.vjp`` of the JAX
    model's train forward on a joined batch."""
    out = {}
    for kind, (classes, _, _) in KINDS.items():
        jmodel = JaxMaskTransUnet(**DP_TINY, dim_output=classes)
        for b, (x, _) in enumerate(inputs["batches"][kind]):
            fwd = jax.jit(lambda p, x=x, m=jmodel: m.apply(
                {"params": p}, jnp.asarray(x), train=True,
                rngs={"dropout": jax.random.PRNGKey(0)}))
            out[kind, b] = jax.vjp(fwd, inputs["params"][kind])
    return out


def _jax_step(inputs, jax_forward, kind, names, batch=0):
    """JAX's (loss, logs, gradients as a port state_dict) of the joined batch."""
    classes, module, _ = KINDS[kind]
    crit = [module.get_criterions(list(names))] * len(DP_TINY["num_layers"])
    labels = jnp.asarray(inputs["batches"][kind][batch][1])
    multi = kind == "multi"
    outs, pullback = jax_forward[kind, batch]

    def loss_fn(o):
        return jax_engine.deep_supervision_loss(
            o[0], o[1], labels, crit, jnp.asarray(DYNAMIC_WEIGHT, jnp.float32),
            criterion_weight=[1.0] * len(names) if multi else None,
            num_classes=classes if multi else None)

    (loss, logs), cotangent = jax.value_and_grad(loss_fn, has_aux=True)(outs)
    grads = pullback(cotangent)[0]
    return float(loss), {k: float(v) for k, v in logs.items()}, from_flax(
        jax.tree.map(np.asarray, grads))


def _joined_step(inputs, kind, names, dropout=0.0):
    """The port's single-process step on the joined batch, dropout from a
    generator seeded as the ranks': (loss, logs, gradients, parameters
    after the update)."""
    classes, _, module = KINDS[kind]
    model = MaskTransUnet(**{**DP_TINY, "dropout": dropout}, dim_output=classes, device="cpu")
    helpers.load_port(model, inputs["params"][kind])
    crit = [module.get_criterions(list(names))] * len(DP_TINY["num_layers"])
    multi = kind == "multi"
    step = engine.make_train_step(model, crit,
                                  criterion_weight=[1.0] * len(names) if multi else None,
                                  num_classes=classes if multi else None)
    state = engine.create_train_state(model, LR)
    x, y = inputs["batches"][kind][0]
    loss, logs = step(state, t(to_ncdhw(x)), t(y), DYNAMIC_WEIGHT,
                      torch.Generator().manual_seed(DROPOUT_SEED))
    return (loss.item(), {k: v.item() for k, v in logs.items()},
            {n: p.grad for n, p in model.named_parameters()},
            {n: p.detach() for n, p in model.named_parameters()})


@pytest.mark.parametrize("case", [c for c in CASES if c not in ("accumulate", "dropout")])
def test_dp_step_equals_the_joined_batch(case, inputs, ranks, jax_forward):
    kind, names, _, _ = CASES[case]
    (loss0, logs0, grads0, params0, _), (loss1, logs1, grads1, params1, _) = (
        r["steps"][case] for r in ranks)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(logs0[k], logs1[k]) for k in logs0)
    for name in params0:
        assert torch.equal(params0[name], params1[name]), name
        assert torch.equal(grads0[name], grads1[name]), name
    assert np.isfinite(loss0.item())

    loss, logs, grads, _ = _joined_step(inputs, kind, names)
    np.testing.assert_allclose(loss0.item(), loss, rtol=1e-6)
    assert list(logs0) == list(logs)
    for k in logs:
        np.testing.assert_allclose(logs0[k].item(), logs[k], rtol=1e-6, atol=1e-8, err_msg=k)
    worst = worst_grad_error(grads0, grads)
    assert worst[1] <= 1e-4, worst

    want_loss, want_logs, want_grads = _jax_step(inputs, jax_forward, kind, names)
    np.testing.assert_allclose(loss0.item(), want_loss, rtol=1e-5)
    for k in want_logs:
        np.testing.assert_allclose(logs0[k].item(), want_logs[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    worst = worst_grad_error(grads0, want_grads)
    assert worst[1] <= 1e-4, worst


def test_dp_step_equals_jax_make_train_step(inputs, ranks):
    """The CLI's criterions through JAX's ``make_train_step`` on the joined
    batch: the loss, and AdamW's first moment after the first update (0.1
    of the gradient, optax's ``mu``) against the ranks' gradients."""
    crit, _ = jax_criterion_list(2, CLI_CRITERIA, jax_binary)
    jmodel = JaxMaskTransUnet(**DP_TINY, dim_output=2)
    state = jax_engine.TrainState.create(apply_fn=jmodel.apply,
                                         params=inputs["params"]["binary"],
                                         tx=jax_engine.make_optimizer(LR))
    step = jax_engine.make_train_step(jmodel, crit, donate=False)
    x, y = inputs["batches"]["binary"][0]
    state, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(DYNAMIC_WEIGHT, jnp.float32), jax.random.PRNGKey(0))
    mu = state.opt_state.inner_state[0].mu
    want = from_flax(jax.tree.map(lambda m: np.asarray(m) / 0.1, mu))

    port_crit, _ = get_criterion_list(2, CLI_CRITERIA)
    assert [list(c) for c in port_crit] == [list(c) for c in crit]
    got_loss, _, got, _, _ = ranks[0]["steps"]["cli"]
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    worst = worst_grad_error(got, want)
    assert worst[1] <= 1e-4, worst


def test_dp_accumulation_matches_optax(inputs, ranks, jax_forward):
    """step_times 2: each micro-step's gradients are averaged over the group
    (the first against JAX's gradient of the first joined batch), the update
    applies their mean (against the mean of JAX's gradients of the two
    joined batches; the 1e-4 rule), and the parameters are those of
    ``optax.MultiSteps(adamw)`` fed with the same two averaged gradients
    (within 1e-6, as ``tests/test_torch_train.py`` holds the optimizer)."""
    import optax

    (loss0, _, grads0, params0, micro), (_, _, _, params1, _) = (
        r["steps"]["accumulate"] for r in ranks)
    assert all(torch.equal(params0[n], params1[n]) for n in params0)
    assert len(micro) == 2
    jax_grads = [_jax_step(inputs, jax_forward, "binary", CLI_CRITERIA, batch=b)
                 for b in (0, 1)]
    np.testing.assert_allclose(loss0.item(), jax_grads[1][0], rtol=1e-5)
    worst = worst_grad_error(micro[0], jax_grads[0][2])
    assert worst[1] <= 1e-4, worst
    want = {n: (jax_grads[0][2][n] + jax_grads[1][2][n]) / 2 for n in grads0}
    worst = worst_grad_error(grads0, want)
    assert worst[1] <= 1e-4, worst

    # optax on the port's state_dict pytree (AdamW's decay covers every leaf
    # either way)
    tx = jax_engine.make_optimizer(LR, 2)
    params = {n: jnp.asarray(v.numpy()) for n, v in from_flax(inputs["params"]["binary"]).items()}
    opt_state = tx.init(params)
    for grads in micro:
        g = {n: jnp.asarray(v.numpy()) for n, v in grads.items()}
        updates, opt_state = tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
    for name, p in params0.items():
        np.testing.assert_allclose(p.numpy(), np.asarray(params[name]), rtol=0, atol=1e-6,
                                   err_msg=name)


def test_rank_masks_are_the_joined_batch_rows(ranks):
    """Each rank's element and channel masks are its rows of the masks one
    process draws for the joined batch from the same seed, and those are
    the draws a mask always was without a mesh."""
    joined_shape = (len(ranks),) + DP_MASK_SHAPE[1:]
    generator = torch.Generator().manual_seed(DROPOUT_SEED)
    with blocks.dropout_generator(generator):
        joined = [blocks.dropout(torch.ones(joined_shape), 0.5, True),
                  blocks.dropout(torch.ones(joined_shape), 0.5, True, channel=True)]
    draws = torch.Generator().manual_seed(DROPOUT_SEED)
    want = [torch.rand(joined_shape, generator=draws) < 0.5,
            torch.rand(joined_shape[:2] + (1, 1, 1), generator=draws) < 0.5]
    for mask, keep in zip(joined, want):
        assert torch.equal(mask, torch.where(keep, 2.0, 0.0).expand(joined_shape))
    for r, result in enumerate(ranks):
        assert len(result["masks"]) == 2
        for got, mask in zip(result["masks"], joined):
            assert torch.equal(got, mask[r:r + 1]), r
    assert not torch.equal(joined[0][0], joined[0][1])
    assert parallel.rank_seed(7, None) == 7


def test_dp_step_with_dropout_equals_the_joined_batch(inputs, ranks):
    """At dropout 0.3 the ranks, their generators seeded alike, take the
    step that one process takes on the joined batch: the loss within 1e-6
    relative, gradients by the file's 1e-4 rule, parameters bit-equal across
    the ranks; and dropout did act (the loss differs from dropout 0's)."""
    kind, names, _, dropout = CASES["dropout"]
    (loss0, logs0, grads0, params0, _), (loss1, logs1, grads1, params1, _) = (
        r["steps"]["dropout"] for r in ranks)
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(logs0[k], logs1[k]) for k in logs0)
    for name in params0:
        assert torch.equal(params0[name], params1[name]), name
    assert np.isfinite(loss0.item())

    loss, logs, grads, _ = _joined_step(inputs, kind, names, dropout)
    np.testing.assert_allclose(loss0.item(), loss, rtol=1e-6)
    for k in logs:
        np.testing.assert_allclose(logs0[k].item(), logs[k], rtol=1e-6, atol=1e-8, err_msg=k)
    worst = worst_grad_error(grads0, grads)
    assert worst[1] <= 1e-4, worst
    assert loss != pytest.approx(_joined_step(inputs, kind, names)[0], rel=1e-3)


def test_batch_norm_takes_the_global_batch(inputs, ranks):
    """C.6: under a mesh SolidBlock's BatchNorm reduces over the global
    batch, as flax's inside JAX's sharded jit: the two ranks together equal
    one process on the joined batch and flax's BatchNorm on it (outputs,
    the input's gradient, the parameters' gradients summed over the ranks,
    the running statistics on every rank), atol 1e-5."""
    from torch_port_helpers import solid_block_step

    solid = inputs["solid"]
    spec = _solid_spec(inputs)
    joined = solid_block_step(spec, (0, 1))
    got = {"out": torch.cat([r["solid"]["out"] for r in ranks]),
           "x_grad": torch.cat([r["solid"]["x_grad"] for r in ranks])}
    grads = {n: sum(r["solid"]["grads"][n] for r in ranks) for n in joined["grads"]}

    jblock = jax_blocks.SolidBlock(SOLID_SHAPE[-1])
    stats = {"solid_layer_1": {"mean": jnp.zeros(12), "var": jnp.ones(12)}}

    def apply(params, x):
        return jblock.apply({"params": params, "batch_stats": stats}, x, train=True,
                            mutable=["batch_stats"])

    (out, updates), vjp = jax.vjp(apply, solid["params"], jnp.asarray(solid["x"]))
    jgrads, jx_grad = vjp((jnp.asarray(solid["cotangent"]),
                           jax.tree_util.tree_map(jnp.zeros_like, updates)))
    jgrads = from_flax(jax.tree_util.tree_map(np.array, jgrads))
    new = updates["batch_stats"]["solid_layer_1"]
    for want in (joined, {"out": t(out), "x_grad": t(jx_grad), "grads": jgrads,
                          "running": (t(new["mean"]), t(new["var"]))}):
        for key in ("out", "x_grad"):
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=1e-5,
                                       rtol=0, err_msg=key)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want["grads"][name].numpy(), atol=1e-5,
                                       rtol=0, err_msg=name)
        for r in ranks:
            for got_stat, want_stat in zip(r["solid"]["running"], want["running"]):
                np.testing.assert_allclose(got_stat.numpy(), want_stat.numpy(), atol=1e-5,
                                           rtol=0)
    # and the check can fail: rank 0's rows alone, as one process, give
    # their own statistics and another output
    alone = solid_block_step({"x": spec["x"][:2], "cotangent": spec["cotangent"][:2],
                              "state": spec["state"]}, (0, 1))
    assert (alone["out"] - got["out"][:2]).abs().max().item() > 1e-3


def _jax_run_batch(volumes):
    runner = jax_engine.SlidingWindowRunner(
        lambda x: jnp.concatenate([x + jnp.mean(x, axis=(1, 2, 3), keepdims=True), -x], -1),
        ROI, 2, overlap=0.6, depth_bucket=4)
    return [np.asarray(o) for o in runner.run_batch([jnp.asarray(v) for v in volumes])]


@pytest.mark.parametrize("mesh", [False, True])
def test_run_batch_matches_jax(inputs, ranks, mesh):
    """Per-volume outputs of run_batch (the group of 3 padded to 4 with the
    first volume) and of batched_predictions, on both ranks, against JAX's
    run_batch (atol 1e-6: the same f32 window sums blended in another
    order); the mesh's outputs equal the single process's bit for bit."""
    want = _jax_run_batch(inputs["volumes"])
    volumes = [t(to_ncdhw(v)) for v in inputs["volumes"]]
    runner = SlidingWindowRunner(
        lambda x: torch.cat([x + x.mean(dim=(2, 3, 4), keepdim=True), -x], dim=1),
        ROI, 2, overlap=0.6, device="cpu")
    single = runner.run_batch(volumes)
    assert [tuple(o.shape) for o in single] == [(1, 2, 8, 8, d) for d in DEPTHS]
    if not mesh:
        got = [single]
    else:
        got = [r["run_batch"][:len(DEPTHS)] for r in ranks]
        got += [[p for _, p in r["batched"]] for r in ranks]
        assert all([i for i, _ in r["batched"]] == [0, 1, 2] for r in ranks)
        for outs in got:
            assert all(torch.equal(o, s) for o, s in zip(outs, single))
    for outs in got:
        for o, w in zip(outs, want):
            np.testing.assert_allclose(o.movedim(1, -1).numpy(), w, rtol=0, atol=1e-6)


def test_run_batch_needs_an_even_split():
    mesh = parallel.Mesh(0, 2, torch.device("cpu"))
    runner = SlidingWindowRunner(lambda x: x, ROI, 1, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        runner.run_batch([torch.zeros((1, 1, 8, 8, 8))] * 3, mesh=mesh)
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(mesh, torch.zeros((3, 2)))


def test_collectives(ranks):
    assert [r["mesh"] for r in ranks] == [(0, 2, "cpu"), (1, 2, "cpu")]
    torch.manual_seed(0)
    rank0 = torch.nn.Linear(3, 2).state_dict()
    for r in ranks:
        assert all(torch.equal(r["replicated"][k], v) for k, v in rank0.items())
        assert torch.equal(r["mean"][0], torch.full((2,), 0.5))
        assert r["mean"][1].dtype == torch.float64 and r["mean"][1].item() == 0.5


class _Items:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.array([i]),)


@pytest.mark.parametrize("n,world,batch", [(8, 2, 2), (7, 2, 2), (7, 3, 1), (2, 4, 1)])
def test_sharded_loader_covers_the_dataset(n, world, batch):
    """Every rank runs the same number of equal batches; together they cover
    every item, and only the wrap-around padding repeats one."""
    shares = []
    for rank in range(world):
        loader = DataLoader(_Items(n), batch_size=batch, shuffle=True, seed=5,
                            num_workers=1, rank=rank, world_size=world)
        batches = [b[0][:, 0].tolist() for b in loader]
        assert len(batches) == len(loader)
        shares.append(batches)
    assert len({len(s) for s in shares}) == 1
    assert len({tuple(len(b) for b in s) for s in shares}) == 1
    items = [i for s in shares for b in s for i in b]
    per_rank = -(-n // world)
    assert len(items) == per_rank * world
    assert sorted(set(items)) == list(range(n))
    order = np.arange(n)
    np.random.default_rng(5 + 1).shuffle(order)  # the first epoch's shuffle
    assert sorted(items) == sorted(np.resize(order, per_rank * world).tolist())
    with pytest.raises(ValueError, match="not in a world"):
        DataLoader(_Items(n), rank=world, world_size=world)


def test_make_mesh_needs_a_group(monkeypatch):
    """Outside a group and without torchrun's environment nothing runs on
    one process instead: make_mesh raises."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert not torch.distributed.is_initialized()
    assert not parallel.distributed_requested()
    with pytest.raises(ValueError):
        parallel.make_mesh(device="cpu")
    with pytest.raises(ValueError, match="not 3"):
        torch.distributed.init_process_group(
            "gloo", init_method="tcp://localhost:0", rank=0, world_size=1)
        try:
            parallel.make_mesh(3, device="cpu")
        finally:
            torch.distributed.destroy_process_group()
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert parallel.distributed_requested()


def test_clis_on_two_ranks(tmp_path):
    """train3d then inference_embed_attn on two gloo ranks (a group the
    caller initialised): one run directory and one metrics log (rank 0's),
    bit-equal parameters on both ranks, and the summary of a
    single-process inference on the same checkpoint (rtol 1e-6: the same
    volumes through the same f32 forward, on one rank or the other)."""
    workdir = str(tmp_path)
    ws = helpers.cli_workspace(os.path.join(workdir, "ws"))
    torch.save(ws, os.path.join(workdir, "workspace.pt"))
    mp.spawn(helpers.cli_worker, args=(2, os.path.join(workdir, "store"), workdir, "train3d"),
             nprocs=2, join=True)

    runs = os.listdir(os.path.join(workdir, "out"))
    assert len(runs) == 1 and os.listdir(os.path.join(workdir, "runs")) == runs
    run = os.path.join(workdir, "out", runs[0])
    assert sorted(os.listdir(os.path.join(run, "fold_0"))) == ["model", "temp_model",
                                                               "train_state"]
    logs = [f for _, _, files in os.walk(os.path.join(workdir, "runs")) for f in files
            if f == "metrics.jsonl"]
    assert logs == ["metrics.jsonl"]
    state = torch.load(os.path.join(run, "fold_0", "train_state"))
    # fold 0 trains 2 patients, one a rank: num_samples (2) steps of a global
    # batch of 2 frames by the end of epoch 0 (one process takes 4 of 1)
    assert state["step"] == 2
    p0, p1 = (torch.load(os.path.join(workdir, f"params{r}.pt")) for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert all(torch.equal(p0[k], v) for k, v in
               torch.load(os.path.join(run, "fold_0", "model"))["state"]["params"].items())
    assert len(os.listdir(os.path.join(workdir, "pred"))) == 1
    two_ranks = json.load(open(os.path.join(workdir, "summary_4_fold.json")))

    single = tmp_path / "single"
    single.mkdir()
    cwd = os.getcwd()
    os.chdir(single)
    try:
        inference_embed_attn.main(helpers.cli_infer_args(ws, run, str(single / "pred")))
    finally:
        os.chdir(cwd)
    one_rank = json.load(open(single / "summary_4_fold.json"))
    assert sorted(two_ranks) == sorted(one_rank) == ["patient_0", "summary_0"]
    for key in one_rank:
        np.testing.assert_allclose(two_ranks[key], one_rank[key], rtol=1e-6, err_msg=key)


def test_monai_cli_on_two_ranks(tmp_path):
    """train3d_monai_version on two gloo ranks: each rank's loader holds one
    of the fold's two training volumes, so each takes one step of a global
    batch of 2; one writer, bit-equal parameters."""
    workdir = str(tmp_path)
    ws = helpers.cli_workspace(os.path.join(workdir, "ws"), multi_class=True)
    torch.save(ws, os.path.join(workdir, "workspace.pt"))
    mp.spawn(helpers.cli_worker, args=(2, os.path.join(workdir, "store"), workdir, "monai"),
             nprocs=2, join=True)
    runs = os.listdir(os.path.join(workdir, "out"))
    assert len(runs) == 1 and os.listdir(os.path.join(workdir, "runs")) == runs
    run = os.path.join(workdir, "out", runs[0], "fold_0")
    assert sorted(os.listdir(run)) == ["model", "temp_model", "train_state"]
    assert torch.load(os.path.join(run, "train_state"))["step"] == 1
    p0, p1 = (torch.load(os.path.join(workdir, f"params{r}.pt")) for r in range(2))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def test_gloo_step_on_the_card_refuses_a_loss_that_reduces_over_the_group():
    """gloo's collectives on CUDA tensors wait on the host, so a CUDA graph
    cannot hold one inside the loss (``ClassifyLoss.over_group``): the step
    refuses it when it is built. Over gloo on the CPU, which runs eagerly,
    it builds."""
    from lintransunet_tpu_torch.losses.multiclass import ClassifyLoss

    criterions = [{"ClassifyLoss": ClassifyLoss()}]
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://localhost:0", rank=0, world_size=1)
    try:
        model = torch.nn.Linear(1, 1)
        with pytest.raises(ValueError, match="NCCL"):
            engine.make_train_step(model, criterions,
                                   mesh=parallel.Mesh(0, 1, torch.device("cuda", 0)))
        engine.make_train_step(model, criterions, mesh=parallel.Mesh(0, 1, torch.device("cpu")))
    finally:
        torch.distributed.destroy_process_group()
