"""Loss zoo (port of ``lintransunet_tpu/losses``): the binary criterions of
the reference's loss/criterions.py and the multi-class ones of
loss/multi_criterions.py, with the same registry names."""

from lintransunet_tpu_torch.losses import binary, multiclass
from lintransunet_tpu_torch.losses.binary import get_criterions

__all__ = ["binary", "multiclass", "get_criterions"]
