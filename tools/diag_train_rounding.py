"""How far the full-width f32 training gradients move at the rounding level.

    python3 tools/diag_train_rounding.py

One f32 train step (TF32 off) of the flagship on ``chip_smoke.py``'s
training patch, from the same weights, batch and dropout generator, taken
five ways: the kernel build twice, the plain-attention build, and the
kernel build twice more under ``torch.use_deterministic_algorithms`` with
cuDNN's deterministic convs (another summation order for some ops). Prints
the loss difference and the largest and median gradient difference (as
``chip_smoke.grad_errors`` counts them) of each pair: run to run, kernel
vs plain, deterministic run to run, deterministic kernel vs plain, and
deterministic vs default algorithms.
"""

import sys
import warnings
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def report(label, got, want):
    errors = chip_smoke.grad_errors(got[1], want[1])
    ranked = sorted(errors.values())
    worst = max(errors.items(), key=lambda kv: kv[1])
    print(f"[rounding] {label}: loss rel {abs(got[0] - want[0]) / abs(want[0]):.3e}, "
          f"median {ranked[len(ranked) // 2]:.3e}, p90 {ranked[int(len(ranked) * 0.9)]:.3e}, "
          f"max {worst[1]:.3e} at {worst[0]}", flush=True)


def main():
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs only on an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, labels, criterions = chip_smoke.train_inputs()

    def step(impl):
        return chip_smoke.train_step_grads(impl, torch.float32, images, labels, criterions)

    kernel, again, plain = step("kernel"), step("kernel"), step("plain")
    report("kernel vs kernel, default algorithms", again, kernel)
    report("kernel vs plain attention, default algorithms", kernel, plain)
    torch.backends.cudnn.deterministic = True
    warnings.filterwarnings("ignore", message=".*deterministic.*")
    torch.use_deterministic_algorithms(True, warn_only=True)
    det, det_again, det_plain = step("kernel"), step("kernel"), step("plain")
    report("kernel vs kernel, deterministic algorithms", det_again, det)
    report("kernel vs plain attention, deterministic algorithms", det, det_plain)
    report("deterministic vs default algorithms, kernel build", det, kernel)


if __name__ == "__main__":
    main()
