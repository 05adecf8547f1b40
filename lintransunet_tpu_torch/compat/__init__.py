"""Interop: flax parameter trees and the JAX package's channels-last layout,
and the reference's own PyTorch checkpoints."""

from lintransunet_tpu_torch.compat.params import from_flax, from_ncdhw, to_ncdhw
from lintransunet_tpu_torch.compat.torch_import import load_reference_state_dict

__all__ = ["from_flax", "from_ncdhw", "to_ncdhw", "load_reference_state_dict"]
