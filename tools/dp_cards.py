"""Data parallelism across K CUDA cards over NCCL: the flagship's DP train step and
``run_batch``, held against one card and timed.

    python3 tools/dp_cards.py [--cards K]       # K cards, one rank each (default: all)

Spawns K ranks as ``torchrun`` would (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``); each forms the group through
``parallel.make_mesh`` (NCCL on ``cuda:LOCAL_RANK``). The reference runs first,
in this process on card 0. Prints:

* ``dp step``: the f32 DP step (TF32 off, dropout 0), one patch a rank,
  against one process's step on the joined batch of K, within
  ``chip_smoke.TRAIN_TOL``; the ranks' parameters bit-equal after it;
* ``run_batch``: K volumes through ``run_batch`` over the mesh (bf16, under
  ``chip_smoke.deterministic``), every volume equal bit for bit to one card's
  runner output, and the volumes per second of K cards against one card's
  (the runner's call on each volume in turn), both warm, the volumes
  already in host memory;
* ``loaded``: ``engine.loop.batched_predictions`` (the eval and inference
  CLIs' loop) over the 2K volumes of the CLIs' workspace, reading and
  preparing each volume included, on K cards against one card: seconds a
  volume, the second of two passes (every rank reads every volume: the
  eval loader is not sharded);
* ``cli``: ``train3d`` then ``inference_embed_attn`` on its checkpoint, each
  started by ``torchrun --standalone --nproc_per_node K`` as a user starts
  them, over ``chip_smoke.py`` phase 10's workspace with 2K volumes (fold 0
  trains K patients, one a rank) and phase 10's flags: both exit 0, one run
  directory with its three artifacts and one ``metrics.jsonl`` (rank 0's),
  num_samples steps of a global batch of K, a finite summary and the
  exports; each launcher's wall time, the processes' start included, and
  ``inference_embed_attn``'s with ``--nproc_per_node 1`` beside it.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from lintransunet_tpu_torch import data, engine, kernels, parallel  # noqa: E402
from lintransunet_tpu_torch.engine.loop import batched_predictions  # noqa: E402
from lintransunet_tpu_torch.cli.common import EvalConfig, get_criterion_list, make_eval_runner  # noqa: E402
from lintransunet_tpu_torch.models import MaskTransUnet, init_random_  # noqa: E402

ROI = (512, 512, 64)          # the served window
EVAL = EvalConfig(roi_size=ROI[0], depth_size=ROI[2], overlap=0.6, mode="constant")


def build(device, dtype, dropout):
    model = MaskTransUnet(**chip_smoke.FLAGSHIP, dtype=dtype, dropout=dropout, device=device)
    return init_random_(model, torch.Generator(device="cpu").manual_seed(chip_smoke.SEED))


def batch(device, k):
    """K seeded patches with the label box, and the criterion schedule."""
    gen = torch.Generator(device="cpu").manual_seed(chip_smoke.SEED + 5)
    images = torch.randn((k,) + chip_smoke.PATCH[1:], generator=gen).to(device)
    labels = torch.zeros((k,) + chip_smoke.PATCH[2:], dtype=torch.long, device=device)
    labels[(slice(None),) + chip_smoke.LABEL_BOX] = 1
    return images, labels, get_criterion_list(5, ["CrossEntroLoss", "DiceClassLoss"])[0]


def volumes(k):
    gen = torch.Generator(device="cpu").manual_seed(chip_smoke.SEED + 14)
    return [torch.randn(chip_smoke.VOLUME, generator=gen) for _ in range(k)]


def sync(device):
    torch.cuda.synchronize(device)


def f32_step(device, images, labels, criterions, mesh=None):
    model = build(device, torch.float32, 0.0).train()
    if mesh is not None:
        parallel.replicate(mesh, model)
        images, labels = parallel.shard_batch(mesh, images), parallel.shard_batch(mesh, labels)
    state = engine.create_train_state(model, learning_rate=1e-4)
    loss, logs = engine.make_train_step(model, criterions, mesh=mesh)(
        state, images, labels, chip_smoke.DYNAMIC_WEIGHT)
    return chip_smoke.step_snapshot(loss, logs, model)


def serve(device, vols, mesh=None):
    """(outputs on the host, seconds for all the volumes, warm)."""
    _, runner = make_eval_runner(build(device, torch.bfloat16, 0.3), EVAL)
    with chip_smoke.deterministic():
        for _ in range(2):  # the second run is timed, warm
            sync(device)
            t0 = time.perf_counter()
            outs = (runner.run_batch(vols, mesh=mesh) if mesh is not None
                    else [runner(v) for v in vols])
            sync(device)
            seconds = time.perf_counter() - t0
    return [o.cpu() for o in outs], seconds


def serve_loaded(device, data_dir, mesh=None):
    """Seconds a volume of ``batched_predictions`` over every volume of
    ``data_dir``, the eval dataset's reading and preparation included: the
    second of two passes."""
    _, runner = make_eval_runner(build(device, torch.bfloat16, 0.3), EVAL)
    dataset = data.EvaPanCTDataset(root=data_dir, depth_size=ROI[2])
    loader = data.DataLoader(dataset, batch_size=1, shuffle=False, num_workers=4)
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        for _ in batched_predictions(loader, runner, mesh):
            pass
        sync(device)
        seconds = time.perf_counter() - t0
    return seconds / len(dataset)


def rank_main(rank, k, port, workdir, data_dir):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))
    with chip_smoke.torchrun_env(rank, k, port, local_rank=rank):
        mesh = parallel.make_mesh()
    try:
        device = mesh.device
        images, labels, criterions = batch(device, k)
        result = {"mesh": (mesh.rank, mesh.size, str(device), dist.get_backend()),
                  "step": f32_step(device, images, labels, criterions, mesh)}
        del images, labels
        outs, result["serve_s"] = serve(device, volumes(k), mesh)
        if rank == 0:
            result["outs"] = outs
        result["loaded_s"] = serve_loaded(device, data_dir, mesh)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--cards", type=int, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    k = args.cards or torch.cuda.device_count()
    if k > torch.cuda.device_count():
        sys.exit(f"{k} cards asked for, {torch.cuda.device_count()} visible")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    kernels.load("linear_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory() as root:
        # the CLIs' workspace: 2K volumes, served whole by ``loaded``
        data_dir, split = chip_smoke.cli_workspace(root, chip_smoke.CLI_SHAPE, 2 * k)
        images, labels, criterions = batch(device, k)
        joined = f32_step(device, images, labels, criterions)
        del images, labels
        vols = volumes(k)
        want, one_s = serve(device, vols)
        one_loaded_s = serve_loaded(device, data_dir)
        torch.cuda.empty_cache()

        workdir = os.path.join(root, "ranks")
        os.makedirs(workdir)
        t0 = time.perf_counter()
        mp.spawn(rank_main, args=(k, chip_smoke.free_port(), workdir, data_dir),
                 nprocs=k, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=True)
                 for r in range(k)]

        print(f"[dp cards] {k} ranks: {[r['mesh'] for r in ranks]}; {spawn_s:.1f} s with the "
              f"processes' start", flush=True)
        steps = [r["step"] for r in ranks]
        if not all(torch.equal(s["params"][n], steps[0]["params"][n]) for s in steps[1:]
                   for n in steps[0]["params"]):
            chip_smoke.fail("the ranks' parameters differ after the DP step")
        loss_rel, worst, median = chip_smoke.compare_steps(
            f"dp step, f32 DP step on {k} ranks vs one process on the joined batch of {k}",
            (steps[0]["loss"], steps[0]["grads"]), (joined["loss"], joined["grads"]))
        tol = chip_smoke.TRAIN_TOL
        if not (loss_rel <= tol["loss"] and worst <= tol["grad"] and median <= tol["grad_median"]):
            chip_smoke.fail("the DP step and the joined batch's step disagree")
        print(f"[dp cards] dp step: within TRAIN_TOL {tol}; the {k} ranks' parameters bit-equal",
              flush=True)
        if not all(torch.equal(o, w) for o, w in zip(ranks[0]["outs"], want)):
            chip_smoke.fail("run_batch over the mesh differs from one card's runner")
        serve_s = max(r["serve_s"] for r in ranks)
        print(f"[dp cards] run_batch: {k} volumes of {chip_smoke.VOLUME[2:]} equal to one card's "
              f"runner, bit for bit; {k / serve_s:.3f} volumes/s on {k} ranks ({serve_s:.3f} s) "
              f"against {k / one_s:.3f} on one card ({one_s:.3f} s), the volumes in host memory",
              flush=True)
        loaded = [r["loaded_s"] for r in ranks]
        print(f"[dp cards] loaded: batched_predictions over {2 * k} volumes of "
              f"{chip_smoke.CLI_SHAPE} (D, H, W), reading and preparing them included: "
              f"{[round(x, 3) for x in loaded]} s a volume on the {k} ranks against "
              f"{one_loaded_s:.3f} s on one card ({one_loaded_s / max(loaded):.2f}x)", flush=True)
        cli_on_cards(k, root, data_dir, split)


def torchrun(k, module, flags, cwd):
    """``torchrun --standalone --nproc_per_node k -m module flags`` in
    ``cwd``; returns its wall seconds, fails on a non-zero exit."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          f"--nproc_per_node={k}", "-m", module, *flags],
                         cwd=cwd, env=env, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if run.returncode != 0:
        print(run.stdout[-4000:], run.stderr[-8000:], flush=True)
        chip_smoke.fail(f"torchrun of {module} exited {run.returncode}")
    return seconds


def cli_on_cards(k, root, data_dir, split):
    """``train3d`` then ``inference_embed_attn`` under ``torchrun`` on k ranks,
    and ``inference_embed_attn`` on one."""
    common = ["--dir_data", data_dir, "--split_json", split]
    train_s = torchrun(k, "lintransunet_tpu_torch.cli.train3d",
                       common + ["--fold_num", "0", "--log_dir", os.path.join(root, "runs"),
                                 "--model_dir", os.path.join(root, "out"),
                                 *chip_smoke.CLI_TRAIN_FLAGS], root)
    runs = os.listdir(os.path.join(root, "out"))
    if len(runs) != 1 or os.listdir(os.path.join(root, "runs")) != runs:
        chip_smoke.fail(f"train3d on {k} ranks wrote run directories {runs}")
    run = os.path.join(root, "out", runs[0])
    artifacts = sorted(os.listdir(os.path.join(run, "fold_0")))
    state = torch.load(os.path.join(run, "fold_0", "train_state"), map_location="cpu",
                       weights_only=True)
    logs = [os.path.join(d, f) for d, _, files in os.walk(os.path.join(root, "runs"))
            for f in files if f == "metrics.jsonl"]
    infer_s = {}
    for ranks in (k, 1):
        infer_s[ranks] = torchrun(ranks, "lintransunet_tpu_torch.cli.inference_embed_attn",
                                  common + ["--pretrained_dir", run,
                                            "--saved_folder", os.path.join(root, f"pred{ranks}"),
                                            *chip_smoke.CLI_INFER_FLAGS], root)
        if ranks == k:
            summary = json.load(open(os.path.join(root, "summary_4_fold.json")))
    exports = len(os.listdir(os.path.join(root, f"pred{k}")))
    samples = int(chip_smoke.CLI_TRAIN_FLAGS[chip_smoke.CLI_TRAIN_FLAGS.index("--num_samples") + 1])
    values = [v for vs in summary.values() for v in np.ravel(vs)]
    if (artifacts != ["model", "temp_model", "train_state"] or len(logs) != 1
            or state["step"] != samples or not values
            or not all(math.isfinite(v) for v in values)):
        chip_smoke.fail(f"the CLIs on {k} ranks: artifacts {artifacts}, {len(logs)} metrics "
                        f"logs, {state['step']} steps (want {samples}), summary {summary}")
    print(f"[dp cards] cli: train3d on {k} ranks ({k} train patients, one a rank, {samples} "
          f"steps of a global batch of {k}, then the eval split over the ranks) {train_s:.1f} s, "
          f"inference_embed_attn on its checkpoint {infer_s[k]:.1f} s on {k} ranks and "
          f"{infer_s[1]:.1f} s on one ({exports} volumes exported), all with the launcher's and "
          f"the processes' start; one run directory with {artifacts} and one metrics.jsonl; "
          f"summary {summary}", flush=True)


if __name__ == "__main__":
    main()
