"""The readings a limit is set from (``limits/<cell>.json``), at a cell's own
sizes on the card: the control, and the training faults read with the
reference put in the program's place. The benchmark's runs never run this.

    python3 -m portbench.readings --workload <cell> --seeds 11 12 13

The control is the reference computed one precision below the
configuration's bf16: every convolution and dense product takes fp8
(e4m3) operands, the rest bf16. Serving: its masks of the run's sampled
volumes, judged as a run judges the program's. Training: its first
``check_steps`` micro-steps against the f32 reference's, and two faults of
the reference against itself: half of each micro-batch left out (the mean
over the rest) and, on a cell of several ranks, the exchange between them
left out (rank 0's gradient alone). The program's own readings are those
every run prints.
"""

import argparse
import contextlib
import json
import sys

import torch

from portbench import check, generate, harness, program
from portbench.loops.worklist import check_sample
from portbench.reference import model as reference
from portbench.reference.runner import blend
from portbench.reference.train import Trainer


def _model(config, state, dtype, dev):
    model = reference.build(config, dtype, dev)
    model.load_state_dict(state)
    return model


def serve(config, traffic, seed, dev) -> dict:
    state = program.weights(config, generate.substream(seed, 0), dev)
    volumes = generate.served_volumes(seed, traffic, dev)
    sample = check_sample(seed, [v.shape[3] for v in volumes], traffic["check_volumes"])
    one_hot = config["eval_output"] == "one_hot"
    control = _model(config, state, torch.bfloat16, dev).eval()
    exact = _model(config, state, torch.float32, dev).eval()
    tally = check.ServeTally()
    for k in sorted(sample):
        volume = torch.from_numpy(volumes[k]).movedim(-1, 1).to(dev)
        with reference.fp8_products():
            served = blend(control, volume, traffic, one_hot)[0] >= traffic["threshold"]
        served_like, soft = blend(exact, volume, traffic, one_hot)
        tally.add(served.float(), served_like, soft, traffic["threshold"])
    return {"control": tally.values()}


def _follow(config, traffic, state, images, label, weights, seed, dev, dtype=torch.float32,
            fp8=False, keep_rows=None, blocks_seen=None):
    """(losses, first gradients, changes) of ``check_steps`` reference
    micro-steps. ``keep_rows``: each block's first rows alone (a fault);
    ``blocks_seen``: the gradient of the first blocks alone (a fault)."""
    model = _model(config, state, dtype, dev)
    trainer = Trainer(model, traffic["learning_rate"], traffic["step_times"])
    generator = torch.Generator(device=dev).manual_seed(generate.substream(seed, 5))
    batch, ranks = traffic["batch"], traffic["ranks"]
    losses, grads = [], None
    for i in range(traffic["check_steps"]):
        first = (i % traffic["pool_batches"]) * batch * ranks
        x = images[first:first + batch * ranks]
        if keep_rows is not None:
            x = torch.cat([x[r * batch:r * batch + keep_rows] for r in range(ranks)])
        n = x.shape[0]
        y = label.expand(n, *label.shape[1:])
        with reference.fp8_products() if fp8 else contextlib.nullcontext():
            losses.append(float(trainer.step(x, y, weights, generator, blocks=ranks,
                                             blocks_seen=blocks_seen)))
        if grads is None and trainer.optimizer.state:
            grads = check.first_gradients(model.named_parameters(), trainer.optimizer)
    changes = {n: float((p.detach() - state[n]).norm()) for n, p in model.named_parameters()}
    del model, trainer
    torch.cuda.empty_cache()
    return {"losses": losses, "grads": grads, "changes": changes}


def train(config, traffic, seed, dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = program.weights(config, generate.substream(seed, 0), dev)
    ranks, batch = traffic["ranks"], traffic["batch"]
    data = generate.patches(seed, traffic, traffic["pool_batches"] * batch * ranks, dev)
    weights = torch.tensor(traffic["level_weights"], device=dev)
    args = (config, traffic, state, data["images"], data["label"], weights, seed, dev)
    exact = _follow(*args)
    out = {"control": check.train_values(_follow(*args, dtype=torch.bfloat16, fp8=True), exact),
           "half_batch": check.train_values(_follow(*args, keep_rows=batch - batch // 2), exact)}
    if ranks > 1:
        out["no_exchange"] = check.train_values(_follow(*args, blocks_seen=1), exact)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.readings: the readings are taken on the card", file=sys.stderr)
        return 2
    bench = harness.manifest()
    cell = {c["name"]: c for c in bench["workloads"]}[args.workload]
    config = generate.load_json("configs", cell["config"])
    traffic = generate.load_json("traffic", cell["traffic"])
    read = train if traffic["kind"] == "train" else serve
    for seed in args.seeds:
        print(json.dumps({"workload": cell["name"], "seed": seed,
                          **read(config, traffic, seed, torch.device("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
