"""The plain training micro-step: the 5-level deep-supervision loss of the
published recipe, autograd, ``step_times`` accumulation and AdamW.

Levels and criteria: the full-resolution output takes CrossEntroLoss +
DiceClassLoss, the level below it the same, the three lower levels
CrossEntroLoss + BalanceDiceLoss, each level weighted by the epoch's
dynamic weight; each lower level's labels are the max-pool pyramid of the
labels. Gradients of ``step_times`` micro-steps are averaged (a running
mean) and AdamW (betas 0.9, 0.999, eps 1e-8, weight decay 0.01) steps on
the last of them.
"""

import torch
import torch.nn.functional as F

from portbench.reference.model import Dropout


def _tokens(p):
    """(N, C, spatial) -> (N, S, C) f32."""
    return p.reshape(p.shape[0], p.shape[1], -1).transpose(1, 2).float()


def _binary_onehot(t):
    t = t.reshape(t.shape[0], -1).float()
    return torch.stack([1.0 - t, t], dim=-1)


def cross_entropy(p, target, eps=1e-5):
    """Weighted CE: weight_c = (S - sum p_c) / S, (1 - p) modulation, log
    clamped at 1e-6."""
    p = _tokens(p)
    t = _binary_onehot(target)
    weight = torch.sum(p, dim=1, keepdim=True) + eps
    total = torch.sum(t, dim=(1, 2), keepdim=True)
    return torch.mean(-(total - weight) / total * (1 - p) * t * torch.log(p.clamp_min(1e-6)))


def dice_class(p, target, eps=1e-9):
    p = _tokens(p)[:, :, 1]
    t = target.reshape(target.shape[0], -1).float()
    return 1.0 - torch.mean((2 * torch.sum(p * t, -1) + eps) / (torch.sum(p + t, -1) + eps))


def balance_dice(p, target, eps=1e-5):
    p = _tokens(p)
    t = _binary_onehot(target)
    w = 1.0 / (torch.sum(t, dim=1, keepdim=True) + eps) ** 2
    cross = 2 * torch.sum(p * t * w, dim=(1, 2)) + eps
    return 1.0 - torch.mean(cross / (torch.sum((p + t) * w, dim=(1, 2)) + eps))


def supervision_loss(out, masks, labels, level_weights):
    """Sum over levels of weight x (its two criteria); level 0 is the
    output, level k the k-th mask from the finest."""
    n = len(level_weights)
    temp = F.max_pool3d(labels.float()[:, None], (2, 2, 1), (2, 2, 1))
    total = torch.zeros((), device=out.device)
    for k in range(n):
        if k == 0:
            pred, target = out, labels
        else:
            pred, target = masks[-k], temp[:, 0]
        second = dice_class if k <= 1 else balance_dice
        total = total + (cross_entropy(pred, target) + second(pred, target)) * level_weights[k]
        if 0 < k < n - 1:
            kernel = (2, 2, 2) if k % 2 == 0 else (2, 2, 1)
            temp = F.max_pool3d(temp, kernel, kernel)
    return total


class Trainer:
    """The micro-step on ``model`` with AdamW at ``lr`` and ``step_times``
    accumulation; ``step(images, labels, level_weights, generator)``
    returns the micro-step's loss."""

    def __init__(self, model, lr=1e-4, step_times=2):
        self.model = model
        self.params = list(model.parameters())
        self.optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                           weight_decay=0.01)
        self.step_times = step_times
        self.mini = 0
        self.acc = [torch.zeros_like(p) for p in self.params]

    def step(self, images, labels, level_weights, generator, blocks: int = 1,
             blocks_seen=None):
        """One micro-step on the batch, run in ``blocks`` equal blocks of
        rows (the gradient of the batch's mean loss is the mean of the
        blocks'); every block draws its dropout from the generator's state
        at the micro-step's start, so the masks are the whole batch's.
        ``blocks_seen`` (a fault the control readings plant): only the first
        blocks make the loss and the gradient, as on a rank that skips the
        exchange with the others."""
        self.model.train()
        for p in self.params:
            p.grad = None
        n = images.shape[0] // blocks
        start = generator.get_state()
        loss = torch.zeros((), device=images.device)
        seen = blocks if blocks_seen is None else blocks_seen
        for b in range(seen):
            generator.set_state(start)
            Dropout.generator, Dropout.block = generator, (b, blocks)
            try:
                out, masks = self.model(images[b * n:(b + 1) * n])
            finally:
                Dropout.generator, Dropout.block = None, (0, 1)
            part = supervision_loss(out, masks, labels[b * n:(b + 1) * n], level_weights) / seen
            part.backward()
            loss += part.detach()
        with torch.no_grad():
            for acc, p in zip(self.acc, self.params):
                grad = torch.zeros_like(p) if p.grad is None else p.grad.float()
                acc.add_((grad - acc) / (self.mini + 1))
            self.mini = (self.mini + 1) % self.step_times
            if self.mini == 0:
                for acc, p in zip(self.acc, self.params):
                    p.grad = acc.clone()
                    acc.zero_()
                self.optimizer.step()
        return loss
