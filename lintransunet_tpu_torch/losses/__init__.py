"""Loss zoo (port of ``lintransunet_tpu/losses``): the binary criterions of
the reference's loss/criterions.py. The multi-class ones come with the
multi-class trainer."""

from lintransunet_tpu_torch.losses import binary
from lintransunet_tpu_torch.losses.binary import get_criterions

__all__ = ["binary", "get_criterions"]
