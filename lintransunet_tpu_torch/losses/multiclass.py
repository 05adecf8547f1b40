"""Multi-class criterions (port of ``lintransunet_tpu/losses/multiclass.py``;
reference: loss/multi_criterions.py).

The 20-entry ``Loss_Dict`` and ``get_criterions``. These take ONE-HOT
targets, channels-first as every prediction of the port:

* ``predict``: (N, C, spatial...) softmax probabilities
* ``target``:  (N, C, spatial...) one-hot labels

(the train and eval loops build the one-hot on the device:
``engine.train.deep_supervision_loss``, ``engine.loop.eval_on_epoch``).
``DistributionLoss``, ``RegionDiceClassLoss`` and ``MaskLoss`` are the
binary module's, as in JAX (which re-exports them outside its registry):
given a one-hot target, ``DistributionLoss``'s marginals sum every
channel.
"""

import torch

from lintransunet_tpu_torch import parallel
from lintransunet_tpu_torch.losses import binary as _binary
from lintransunet_tpu_torch.losses.functional import flatten_tokens


def _pair(predict, target):
    return flatten_tokens(predict), flatten_tokens(target)


class DiceLoss:
    """Mean per-class dice (multi_criterions.py:8-28)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        cross = 2 * torch.sum(p * t, dim=1) + self.eps
        total = torch.sum(p + t, dim=1) + self.eps
        return 1.0 - torch.mean(cross / total)


class _DiceClass:
    def __init__(self, class_index: int, eps: float = 1e-9):
        self.class_index = class_index
        self.eps = eps

    def _select(self, x):
        return x[:, :, self.class_index]

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        cp, ct = self._select(p), self._select(t)
        cross = 2 * torch.sum(cp * ct, dim=-1) + self.eps
        total = torch.sum(cp + ct, dim=-1) + self.eps
        return 1.0 - torch.mean(cross / total)


class DiceClassLoss0(_DiceClass):
    """Foreground-union dice: 1 - channel 0 (multi_criterions.py:30-55)."""

    def __init__(self, class_index: int = 0, eps: float = 1e-9):
        super().__init__(class_index, eps)

    def _select(self, x):
        return 1.0 - x[:, :, 0]


class DiceClassLoss(_DiceClass):
    """(multi_criterions.py:58-83)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-9):
        super().__init__(class_index, eps)


class DiceClassLoss2(_DiceClass):
    """(multi_criterions.py:85-110)."""

    def __init__(self, class_index: int = 2, eps: float = 1e-9):
        super().__init__(class_index, eps)


# the raw-label classes of the binary module, as the reference's multi-class
# file re-declares them
RegionDiceClassLoss = _binary.RegionDiceClassLoss
DistributionLoss = _binary.DistributionLoss
MaskLoss = _binary.MaskLoss


class LocalizationLoss:
    """Foreground (1 - p0) marginal CDF loss (multi_criterions.py:219-281):
    1 - channel 0 for predict and target, the first-axis term only, and no
    8x scale (line 280)."""

    def __init__(self, class_index: int = 1, eps: float = 1e-6):
        self.class_index = class_index
        self.eps = eps
        self.mask_threshold = 10.0

    def __call__(self, predict, target):
        p = 1.0 - predict.float()[:, 0:1]
        t = 1.0 - target.float()[:, 0:1]
        pm = torch.sigmoid(_binary._axis_marginals(p)[0] - self.mask_threshold)
        tm = torch.sigmoid(_binary._axis_marginals(t)[0] - self.mask_threshold)
        return _binary._cdf_l1(pm, tm, self.eps, scale=1.0)


class _ClassRatioOneHot:
    """Recall / precision over one-hot targets (multi_criterions.py:320-490)."""

    def __init__(self, class_index: int, eps: float = 1e-5,
                 denom: str = "target", complement: bool = False):
        self.class_index = class_index
        self.eps = eps
        self.denom = denom
        self.complement = complement

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        cp, ct = p[:, :, self.class_index], t[:, :, self.class_index]
        cross = torch.sum(cp * ct, dim=-1) + self.eps
        denom = torch.sum(ct if self.denom == "target" else cp, dim=-1) + self.eps
        value = torch.mean(cross / denom)
        return 1.0 - value if self.complement else value


class Recall(_ClassRatioOneHot):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, "target", False)


class Recall2(_ClassRatioOneHot):
    def __init__(self, class_index: int = 2, eps: float = 1e-5):
        super().__init__(class_index, eps, "target", False)


class RecallLoss(_ClassRatioOneHot):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, "target", True)


class Precision(_ClassRatioOneHot):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, "predict", False)


class Precision2(_ClassRatioOneHot):
    def __init__(self, class_index: int = 2, eps: float = 1e-5):
        super().__init__(class_index, eps, "predict", False)


class PrecisionLoss(_ClassRatioOneHot):
    def __init__(self, class_index: int = 1, eps: float = 1e-5):
        super().__init__(class_index, eps, "predict", True)


class BalanceDiceLoss:
    """(multi_criterions.py:493-515)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        w = 1.0 / (torch.sum(t, dim=1, keepdim=True) + self.eps) ** 2
        cross = 2 * torch.sum(p * t * w, dim=(1, 2)) + self.eps
        total = torch.sum((p + t) * w, dim=(1, 2)) + self.eps
        return 1.0 - torch.mean(cross / total)


class BalanceDiceLoss2(BalanceDiceLoss):
    """Background-excluding balanced dice (multi_criterions.py:517-541)."""

    def __call__(self, predict, target):
        return super().__call__(predict[:, 1:], target[:, 1:])


class IOULoss:
    """(multi_criterions.py:544-564)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        cross = torch.sum(p * t, dim=1) + self.eps
        total = torch.sum(p + t, dim=1) + self.eps
        return 1.0 - torch.mean(cross / (total - cross))


class FocalLoss:
    """(multi_criterions.py:568-591); unclamped log, as there."""

    def __init__(self, gamma: float = 2.0, eps: float = 1e-9):
        self.gamma = gamma
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        return torch.mean(-((1 - p) ** self.gamma) * t * torch.log(p))


class CrossEntroLoss:
    """The weighted CE over one-hot targets (multi_criterions.py:594-615)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        logp = torch.log(torch.clamp(p, min=1e-6))
        weight = torch.sum(p, dim=1, keepdim=True) + self.eps
        total = torch.sum(t, dim=(1, 2), keepdim=True)
        weight = (total - weight) / total
        return torch.mean(-weight * (1 - p) * t * logp)


class ClassifyLoss:
    """Expected-class MSE over foreground voxels (multi_criterions.py:617-636).

    The only criterion that couples a batch's samples: a ratio of sums over
    the whole batch. ``over_group`` is its value on a data-parallel rank."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def _sums(self, predict, target):
        """(sum of fg * squared error, foreground voxel count)."""
        p, t = _pair(predict, target)
        weights = torch.arange(p.shape[-1], dtype=torch.float32, device=p.device)
        tc = torch.sum(weights * t, dim=-1)
        pc = torch.sum(weights * p, dim=-1)
        fg = 1.0 - t[:, :, 0]
        return torch.sum(fg * (pc - tc) ** 2), torch.sum(fg)

    def __call__(self, predict, target):
        error, count = self._sums(predict, target)
        return error / (count + self.eps)

    def over_group(self, mesh, predict, target):
        """This rank's share of the global batch's loss, scaled so that the
        mean over ranks (the DP step's average) is the global value and its
        gradient: ``size * error_rank / (count_global + eps)``. The count
        depends on the targets alone, so its sum over the group carries no
        gradient."""
        error, count = self._sums(predict, target)
        total = parallel.all_reduce_sum(mesh, count.detach().clone())
        return mesh.size * error / (total + self.eps)


class CrossEntroLoss0:
    """Background-vs-rest weighted CE (multi_criterions.py:640-663)."""

    def __init__(self, eps: float = 1e-5):
        self.eps = eps

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        p2 = torch.stack([p[:, :, 0], 1 - p[:, :, 0]], dim=-1)
        t2 = torch.stack([t[:, :, 0], 1 - t[:, :, 0]], dim=-1)
        logp = torch.log(torch.clamp(p2, min=1e-6))
        weight = torch.sum(p2, dim=1, keepdim=True) + self.eps
        total = torch.sum(t2, dim=(1, 2), keepdim=True)
        weight = (total - weight) / total
        return torch.mean(-weight * (1 - p2) * t2 * logp)


class MSEcLoss:
    """(multi_criterions.py:666-679)."""

    def __init__(self, reduction: str = "mean"):
        if reduction != "mean":
            raise ValueError(f"MSEcLoss supports reduction='mean' only, not {reduction!r}")

    def __call__(self, predict, target):
        p, t = _pair(predict, target)
        return torch.mean((p - t) ** 2)


Loss_Dict = {
    "DiceLoss": DiceLoss,
    "DiceClassLoss0": DiceClassLoss0,
    "DiceClassLoss": DiceClassLoss,
    "DiceClassLoss2": DiceClassLoss2,
    "BalanceDiceLoss": BalanceDiceLoss,
    "BalanceDiceLoss2": BalanceDiceLoss2,
    "IOULoss": IOULoss,
    "FocalLoss": FocalLoss,
    "CrossEntroLoss": CrossEntroLoss,
    "CrossEntroLoss0": CrossEntroLoss0,
    "MSELoss": MSEcLoss,
    "Recall": Recall,
    "Precision": Precision,
    "Recall2": Recall2,
    "Precision2": Precision2,
    "RecallLoss": RecallLoss,
    "PrecisionLoss": PrecisionLoss,
    "DistributionLoss": DistributionLoss,
    "LocalizationLoss": LocalizationLoss,
    "ClassifyLoss": ClassifyLoss,
}


def get_criterions(name_list):
    """Name list -> {name: loss callable} (multi_criterions.py:704-713)."""
    return {name: Loss_Dict[name]() for name in name_list}
