"""Binary segmentation criterions (port of
``lintransunet_tpu/losses/binary.py``; reference: loss/criterions.py).

Every class the 16-entry ``Loss_Dict`` names, ``get_criterions``, and the
five losses outside the registry: ``RegionDiceClassLoss``, ``MaskLoss``,
``RegionCrossEntroLoss``, ``SolidLoss`` and ``PyramidLoss``.
Losses are stateless callables ``loss(predict, target)`` with

* ``predict``: (N, C, spatial...) softmax probabilities (channels-first)
* ``target``:  (N, spatial...) or (N, 1, spatial...) integer class ids

and the reference's quirks kept as the JAX package keeps them: the stacked
binary one-hot, the clamped-log weighted CE, the eps placements, the
fixed-and-flagged DistributionLoss axis loop, and LocalizationLoss's three
identical first-axis terms.
"""

import torch

from lintransunet_tpu_torch.losses.functional import (
    binary_onehot,
    flatten_labels,
    flatten_tokens,
    one_hot,
)
from lintransunet_tpu_torch.ops.pool import avg_pool2d


class DiceLoss:
    """Mean per-class dice over the stacked binary one-hot (criterions.py:8-32)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = binary_onehot(flatten_labels(target))
        cross = 2 * torch.sum(p * t, dim=1) + self.eps
        total = torch.sum(p + t, dim=1) + self.eps
        return 1.0 - torch.mean(cross / total)


class DiceClassLoss:
    """Dice of one class channel against the raw label (criterions.py:35-70)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-9):
        self.class_index = class_index
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)[:, :, self.class_index]
        t = flatten_labels(target)
        cross = 2 * torch.sum(p * t, dim=-1) + self.eps
        total = torch.sum(p + t, dim=-1) + self.eps
        return 1.0 - torch.mean(cross / total)


class RegionDiceClassLoss:
    """Half-weighted asymmetric dice (criterions.py:73-116, the distance
    path disabled, as in the JAX package)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        self.class_index = class_index
        self.eps = eps

    def __call__(self, predict, target, dist=None, surface_distance=None):
        p = flatten_tokens(predict)[:, :, self.class_index]
        t = flatten_labels(target)
        w = 0.5
        cross = torch.sum(p * t, dim=-1) + self.eps
        total = torch.sum(w * p + (1 - w) * t, dim=-1) + self.eps
        return 1.0 - torch.mean(cross / total)


def _cdf_l1(pred_marginal, target_marginal, eps: float, scale: float = 1.0):
    """Cumulative-marginal L1 (dis_loss, criterions.py:165-176, 230-241)."""
    dp = torch.cumsum(pred_marginal, dim=-1) / (
        torch.sum(pred_marginal, dim=-1, keepdim=True) + eps)
    dt = torch.cumsum(target_marginal, dim=-1) / (
        torch.sum(target_marginal, dim=-1, keepdim=True) + eps)
    return scale * torch.mean(torch.abs(dp - dt))


def _axis_marginals(x):
    """Per-spatial-axis marginals of (N, 1, S0, S1, S2) channel maps:
    [(N, 1, S_i)], each summing the channel and the other axes."""
    n_dim = x.dim() - 2
    outs = []
    for i in range(n_dim):
        dims = (1,) + tuple(j + 2 for j in range(n_dim) if j != i)
        outs.append(torch.sum(x, dim=dims)[:, None, :])
    return outs


def _target_map(target, like):
    """Target ids as an f32 (N, 1, spatial...) map beside ``like``."""
    t = target.float()
    return t[:, None] if t.dim() == like.dim() - 1 else t


class DistributionLoss:
    """Axis-marginal CDF matching (criterions.py:119-176). The reference
    loop reuses a stale ``dim_predict`` for axes > 0; fixed, as in the JAX
    package: each spatial axis contributes its own marginal."""

    def __init__(self, class_index: int = 1, eps: float = 1e-7):
        self.class_index = class_index
        self.eps = eps
        self.mask_threshold = 0.5
        self.mask_region = 0.05

    def __call__(self, predict, target):
        p = torch.sigmoid((predict.float() - self.mask_threshold) / self.mask_region)
        p = p[:, self.class_index:self.class_index + 1]
        t = _target_map(target, p)
        losses = [_cdf_l1(pm, tm, self.eps)
                  for pm, tm in zip(_axis_marginals(p), _axis_marginals(t))]
        return sum(losses) / len(losses)


class LocalizationLoss:
    """Sigmoid-thresholded marginal CDF loss (criterions.py:179-241). The
    reference transposes only on its first iteration, so its three terms
    are the same first-axis term: computed once (scale 8, line 240)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-6):
        self.class_index = class_index
        self.eps = eps
        self.mask_threshold = 10.0

    def __call__(self, predict, target):
        p = predict.float()[:, self.class_index:self.class_index + 1]
        t = _target_map(target, p)
        pm = torch.sigmoid(_axis_marginals(p)[0] - self.mask_threshold)
        tm = torch.sigmoid(_axis_marginals(t)[0] - self.mask_threshold)
        return _cdf_l1(pm, tm, self.eps, scale=8.0)


class MaskLoss:
    """Dice over a one-channel mask (criterions.py:244-277): channel 0 of
    ``predict`` against the raw label."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)[..., 0]
        t = flatten_labels(target)
        cross = 2 * torch.sum(p * t, dim=-1) + self.eps
        total = torch.sum(p + t, dim=-1) + self.eps
        return 1.0 - torch.mean(cross / total)


class _ClassRatio:
    """Shared recall/precision skeleton (criterions.py:280-413)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-5,
                 denom: str = "target", complement: bool = False):
        self.class_index = class_index
        self.eps = eps
        self.denom = denom
        self.complement = complement

    def __call__(self, predict, target):
        p = flatten_tokens(predict)[:, :, self.class_index]
        t = flatten_labels(target)
        cross = torch.sum(p * t, dim=-1) + self.eps
        denom = torch.sum(t if self.denom == "target" else p, dim=-1) + self.eps
        value = torch.mean(cross / denom)
        return 1.0 - value if self.complement else value


class Recall(_ClassRatio):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, denom="target", complement=False)


class RecallLoss(_ClassRatio):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, denom="target", complement=True)


class Precision(_ClassRatio):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, denom="predict", complement=False)


class PrecisionLoss(_ClassRatio):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, denom="predict", complement=True)


class BalanceDiceLoss:
    """Inverse-square class-frequency weighted dice (criterions.py:416-442)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = binary_onehot(flatten_labels(target))
        w = 1.0 / (torch.sum(t, dim=1, keepdim=True) + self.eps) ** 2
        cross = 2 * torch.sum(p * t * w, dim=(1, 2)) + self.eps
        total = torch.sum((p + t) * w, dim=(1, 2)) + self.eps
        return 1.0 - torch.mean(cross / total)


class SolidLoss:
    """BCE on the volume's solidity, its target voxel count above
    ``threshold`` (criterions.py:445-463; outside ``Loss_Dict``):
    ``predict`` is the (N, 1) solid probability."""

    def __init__(self, threshold: float = 10.0):
        self.threshold = threshold

    def __call__(self, predict, target):
        t = flatten_labels(target)
        solid = (torch.sum(t, dim=-1) > self.threshold).float()[:, None]
        p = predict.float()
        return torch.mean(-(solid * torch.log(p) + (1 - solid) * torch.log(1 - p)))


class ContainLoss:
    """Asymmetric containment dice (criterions.py:466-497), alpha=0.4."""

    default_alpha = 0.4

    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        self.class_index = class_index
        self.eps = eps

    def __call__(self, predict, target, alpha: float = None):
        if alpha is None:
            alpha = self.default_alpha
        p = flatten_tokens(predict)[:, :, self.class_index]
        t = flatten_labels(target)
        cross = torch.sum(p * t, dim=-1) + self.eps
        st = torch.sum(t, dim=-1) + self.eps
        sp = torch.sum(p, dim=-1) + self.eps
        return 1.0 - torch.mean(cross / ((1 - alpha) * st + alpha * sp))


class ContainLoss2(ContainLoss):
    """ContainLoss with alpha=0.3 (criterions.py:499-529)."""

    default_alpha = 0.3


class PyramidLoss:
    """Multi-scale containment loss over a 2D mask pyramid
    (criterions.py:533-560; outside ``Loss_Dict``). The reference builds
    ContainLoss with an ``alpha`` its __init__ does not take (line 543); as
    in the JAX package, alpha = 0.2 (i + 1) / n is passed at call time.
    ``mask_list``: (N, C, H_i, W_i) masks, coarse to fine; ``target``:
    (N, 1, H, W), pooled 5x5 with stride 2 once per level and thresholded
    at 0.2."""

    def __init__(self, n: int = 3):
        self.n = n
        self.kernel_size = 5
        self.threshold = 0.2
        self.contain = [ContainLoss(class_index=1) for _ in range(n)]
        self.alphas = [0.2 * (i + 1) / n for i in range(n)]

    def __call__(self, mask_list, target):
        t = target.float()
        losses = []
        for i in range(self.n):
            t = avg_pool2d(t, self.kernel_size, 2, self.kernel_size // 2)
            label = (t > self.threshold).float()
            losses.append(self.contain[-i - 1](mask_list[-i - 1], label[:, 0],
                                               alpha=self.alphas[-i - 1]))
        return sum(losses) / self.n


class IOULoss:
    """IoU loss over true one-hot targets (criterions.py:563-585)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = one_hot(flatten_labels(target), p.shape[-1])
        cross = torch.sum(p * t, dim=1) + self.eps
        total = torch.sum(p + t, dim=1) + self.eps
        return 1.0 - torch.mean(cross / (total - cross))


class SSLoss:
    """Sensitivity-specificity loss, sigma=0.05 (criterions.py:588-615)."""

    def __init__(self, sigma: float = 0.05, eps: float = 1e-5):
        self.sigma = sigma
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = one_hot(flatten_labels(target), p.shape[-1])
        l2 = (p - t) ** 2
        sens = torch.sum(l2 * t, dim=1) / (torch.sum(t, dim=1) + self.eps)
        spec = torch.sum(l2 * (1 - t), dim=1) / (torch.sum(1 - t, dim=1) + self.eps)
        return torch.mean(self.sigma * sens + (1 - self.sigma) * spec)


class FocalLoss:
    """Focal loss, gamma=2 (criterions.py:618-644). Unclamped log, as there."""

    def __init__(self, gamma: float = 2.0, eps: float = 1e-9):
        self.gamma = gamma
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = one_hot(flatten_labels(target), p.shape[-1])
        return torch.mean(-((1 - p) ** self.gamma) * t * torch.log(p))


class RegionCrossEntroLoss:
    """Plain CE with an eps-shifted log (criterions.py:647-693, the distance
    path disabled, as in the JAX package)."""

    def __init__(self, eps: float = 1e-9):
        self.eps = eps

    def __call__(self, predict, target, dist=None, surface_distance=None):
        p = flatten_tokens(predict)
        t = one_hot(flatten_labels(target), p.shape[-1])
        return torch.mean(-t * torch.log(p + self.eps))


class CrossEntroLoss:
    """The reference's weighted CE (criterions.py:696-735): weight_c =
    (S - sum_tokens p_c) / S per class, (1 - p) modulation, log clamped at
    1e-6; S enters through the one-hot total (line 717)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = binary_onehot(flatten_labels(target))
        logp = torch.log(torch.clamp(p, min=1e-6))
        weight = torch.sum(p, dim=1, keepdim=True) + self.eps  # (N, 1, C)
        total = torch.sum(t, dim=(1, 2), keepdim=True)         # (N, 1, 1) == S
        weight = (total - weight) / total
        return torch.mean(-weight * (1 - p) * t * logp)


class MSEcLoss:
    """MSE against the true one-hot (criterions.py:738-752)."""

    def __init__(self, reduction: str = "mean"):
        if reduction != "mean":
            raise ValueError(f"MSEcLoss supports reduction='mean' only, not {reduction!r}")

    def __call__(self, predict, target):
        p = flatten_tokens(predict)
        t = one_hot(flatten_labels(target), p.shape[-1])
        return torch.mean((p - t) ** 2)


Loss_Dict = {
    "DiceLoss": DiceLoss,
    "DiceClassLoss": DiceClassLoss,
    "BalanceDiceLoss": BalanceDiceLoss,
    "IOULoss": IOULoss,
    "SSLoss": SSLoss,
    "FocalLoss": FocalLoss,
    "CrossEntroLoss": CrossEntroLoss,
    "ContainLoss": ContainLoss,
    "ContainLoss2": ContainLoss2,
    "MSELoss": MSEcLoss,
    "Recall": Recall,
    "Precision": Precision,
    "RecallLoss": RecallLoss,
    "PrecisionLoss": PrecisionLoss,
    "DistributionLoss": DistributionLoss,
    "LocalizationLoss": LocalizationLoss,
}


def get_criterions(name_list):
    """Name list -> {name: loss callable} (criterions.py:773-782)."""
    return {name: Loss_Dict[name]() for name in name_list}
