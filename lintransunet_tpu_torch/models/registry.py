"""The flagship model, ``MaskTransUnet`` (port of
``lintransunet_tpu/models/registry.py``; reference: trans_3DUnet.py:150-204).
"""

from typing import Optional, Sequence, Union

import torch
from torch import nn

from lintransunet_tpu_torch.models.blocks import (
    MultiheadLinearAttention,
    _TokenStack,
    lecun_normal_,
)
from lintransunet_tpu_torch.models.unet import Encoder, ROIDecoder

ATTENTION_IMPLS = ("kernel", "plain")
# Levels whose stride-1 convs the fused configuration routes through the
# conv unit: the flagship's packed_levels=2 in the JAX package.
FUSED_S1_LEVELS = 2


def _resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device when none is
    visible, so that nothing quietly builds on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: MaskTransUnet runs on the card unless "
            "it is built with device='cpu'")
    return device


def one_hot_argmax(out: torch.Tensor) -> torch.Tensor:
    """Channel argmax -> one-hot in ``out``'s dtype (trans_3DUnet.py:199-202);
    ties go to the lowest class."""
    idx = out.argmax(dim=1, keepdim=True)
    classes = torch.arange(out.shape[1], device=out.device).view(1, -1, 1, 1, 1)
    return (idx == classes).to(out.dtype)


class MaskTransUnet(nn.Module):
    """Encoder -> ROIDecoder on (N, C, H, W, D).

    ``dtype`` is the compute dtype (bf16 for the flagship); parameters stay
    f32. The model is built on ``device``, the card unless the caller asks
    for the CPU; without a visible CUDA device the default raises.

    This constructor is the one place that picks the kernels:
    ``attention_impl`` selects, for every unfused attention layer, the
    fused op ("kernel": the CUDA kernel on the card) or its plain version
    ("plain"), so the two can be compared on one set of weights.
    ``fused_s1`` and ``fused_stack`` turn on the fused eval configuration,
    the JAX package's ``LINTRANSUNET_FUSED_S1=1`` and
    ``LINTRANSUNET_FUSED_STACK=1`` at ``packed_levels=2``: the stride-1
    convs of the top ``FUSED_S1_LEVELS`` levels run through the conv unit,
    and every token stack through the fused transformer stack. Both are
    eval-only and off by default, as in JAX: a model built with either is
    put in eval mode, and ``train()`` on it raises ``ValueError``.

    In train mode ``forward(x)`` returns (probabilities, mask_list), as
    JAX's ``return_aux=True``; its dropouts draw from the generator of
    ``blocks.dropout_generator``.
    """

    def __init__(self, num_layers: Sequence[int], roi_size_list: Sequence[int],
                 is_roi_list: Sequence[bool], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3, n_layers: int = 8,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 attention_impl: str = "kernel", fused_s1: bool = False,
                 fused_stack: bool = False):
        super().__init__()
        if attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
        device = _resolve_device(device)
        self.dim_output = dim_output
        self.dtype = dtype
        self.fused_s1 = fused_s1
        self.fused_stack = fused_stack
        levels = FUSED_S1_LEVELS if fused_s1 else 0
        self.encode = Encoder(num_layers, dim_input, kernel_size, dropout,
                              fused_s1_levels=levels)
        self.decode = ROIDecoder(num_layers, roi_size_list, is_roi_list,
                                 dim_output, kernel_size, dropout=dropout,
                                 n_layers=n_layers, fused_s1_levels=levels)
        for m in self.modules():
            if isinstance(m, MultiheadLinearAttention):
                m.attention_impl = attention_impl
            elif isinstance(m, _TokenStack):
                m.fused_stack = fused_stack
        self.to(device)
        if fused_s1 or fused_stack:
            self.eval()

    def train(self, mode: bool = True):
        if mode and (self.fused_s1 or self.fused_stack):
            raise ValueError("fused_s1 and fused_stack are eval only, as in the "
                             "JAX package: build the model without them to train")
        return super().train(mode)

    def forward(self, x: torch.Tensor, return_aux: Optional[bool] = None,
                fg_only: bool = False):
        """``return_aux`` (default: ``self.training``) selects the
        (probabilities, mask_list) branch over the one-hot argmax branch.
        ``fg_only`` (eval branch, 2 classes) returns only the class-1 channel:
        1 where logit 1 > logit 0 strictly, so a tie goes to class 0."""
        if fg_only and self.dim_output != 2:
            raise ValueError("fg_only eval requires dim_output == 2")
        if return_aux is None:
            return_aux = self.training
        bottle, skips = self.encode(x.to(self.dtype))
        out, mask_list = self.decode(bottle, skips, apply_softmax=return_aux)
        if return_aux:
            return out, mask_list
        if fg_only:
            return (out[:, 1:2] > out[:, 0:1]).to(out.dtype)
        return one_hot_argmax(out)


def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill ``model``'s parameters in place from ``generator`` (a CPU
    generator) as flax's default initialisers do: weights by
    ``lecun_normal_`` (a truncated normal of variance 1 / fan_in), biases
    zero, LayerNorm scales one."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.copy_(lecun_normal_(torch.empty(p.shape), generator))
    return model
