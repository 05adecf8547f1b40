"""The model zoo and its registry (port of
``lintransunet_tpu/models/registry.py``; reference: trans_3DUnet.py:1-222):
the flagship ``MaskTransUnet`` and the four other models of ``Model_Dict``.

Every model takes ``dtype`` (the compute dtype; parameters stay f32),
``device`` (the card unless the caller asks for the CPU; without a visible
CUDA device the default raises) and ``attention_impl`` ("kernel": every
unmasked attention layer runs the fused op, the CUDA kernel on the card;
"plain": its plain version). Outputs follow the JAX package's: the flagship
returns (probabilities, mask_list) in training and the one-hot argmax in
eval; ``TraditionUnet``, ``BottleTransUnet`` and ``SkipTransUnet`` return
the softmax probabilities in both modes; ``MaskSkipTransUnet`` returns
(probabilities, mask_list) in both. Every forward runs in a profiler span
``model`` (``utils.profiling.span``), and each op of it in one stage span
inside: the encoder's, a bridge's or the decoder's.
"""

from typing import Optional, Sequence, Union

import torch
from torch import nn

from lintransunet_tpu_torch.models.blocks import (
    MultiheadLinearAttention,
    _TokenStack,
    lecun_normal_,
)
from lintransunet_tpu_torch.models.bridges import Bridge, ConnectBridge
from lintransunet_tpu_torch.models.unet import Decoder, Encoder, ROIDecoder
from lintransunet_tpu_torch.utils import profiling

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
            "no CUDA device is visible: the model runs on the card unless "
            "it is built with device='cpu'")
    return device


def _place(model: nn.Module, attention_impl: str,
           device: Union[str, torch.device]) -> None:
    """Set every attention layer's ``attention_impl`` and move ``model`` to
    ``device``."""
    if attention_impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention_impl must be one of {ATTENTION_IMPLS}")
    device = _resolve_device(device)
    for m in model.modules():
        if isinstance(m, MultiheadLinearAttention):
            m.attention_impl = attention_impl
    model.to(device)


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
            if isinstance(m, _TokenStack):
                m.fused_stack = fused_stack
        _place(self, attention_impl, device)
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
        with profiling.span("model"):
            bottle, skips = self.encode(x, self.dtype)
            out, mask_list = self.decode(bottle, skips, apply_softmax=return_aux)
            if return_aux:
                return out, mask_list
            with profiling.span("decoder.head"):
                if fg_only:
                    return (out[:, 1:2] > out[:, 0:1]).to(out.dtype)
                return one_hot_argmax(out)


class _UnetModel(nn.Module):
    """Encoder -> (bridges) -> ``Decoder``: the base of the four models of
    ``Model_Dict`` beside the flagship. ``forward`` casts the input to the
    compute dtype and hands it to ``_forward``."""

    def __init__(self, num_layers: Sequence[int], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3):
        super().__init__()
        self.num_layers = tuple(num_layers)
        self.dim_output = dim_output
        self.encode = Encoder(num_layers, dim_input, kernel_size, dropout)
        self.decode = Decoder(num_layers, dim_output, kernel_size, dropout)

    def _finish(self, dtype, device, attention_impl):
        self.dtype = dtype
        _place(self, attention_impl, device)

    def forward(self, x: torch.Tensor):
        with profiling.span("model"):
            return self._forward(*self.encode(x, self.dtype))


class TraditionUnet(_UnetModel):
    """Plain 3D UNet (trans_3DUnet.py:7-35)."""

    def __init__(self, num_layers: Sequence[int], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 attention_impl: str = "kernel"):
        super().__init__(num_layers, dim_input, dim_output, kernel_size, dropout)
        self._finish(dtype, device, attention_impl)

    def _forward(self, bottle, skips):
        return self.decode(bottle, skips)


class BottleTransUnet(_UnetModel):
    """UNet with a 4-layer bottleneck transformer, 8 heads (trans_3DUnet.py:38-68)."""

    def __init__(self, num_layers: Sequence[int], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 attention_impl: str = "kernel"):
        super().__init__(num_layers, dim_input, dim_output, kernel_size, dropout)
        self.connect_bridge = ConnectBridge(num_layers[-1], 8, dropout, 4)
        self._bridge_span = f"bridge.level{len(num_layers) - 1}"
        self._finish(dtype, device, attention_impl)

    def _forward(self, bottle, skips):
        with profiling.span(self._bridge_span):
            bottle = self.connect_bridge(bottle)
        return self.decode(bottle, skips)


class SkipTransUnet(_UnetModel):
    """A 4-layer, 8-head ConnectBridge per level (trans_3DUnet.py:71-111). As
    the reference (and the JAX package), the skips' bridges run and their
    outputs are dropped: the decoder takes the raw skips and the bridged
    bottleneck."""

    def __init__(self, num_layers: Sequence[int], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 attention_impl: str = "kernel"):
        super().__init__(num_layers, dim_input, dim_output, kernel_size, dropout)
        for i, width in enumerate(num_layers):
            self.add_module(f"connect_bridge_list_{i}", ConnectBridge(width, 8, dropout, 4))
        self._bridge_spans = [f"bridge.level{i}" for i in range(len(num_layers))]
        self._finish(dtype, device, attention_impl)

    def _forward(self, bottle, skips):
        n = len(self.num_layers)
        for i in range(n - 1):
            with profiling.span(self._bridge_spans[i]):
                getattr(self, f"connect_bridge_list_{i}")(skips[i])  # dead compute, kept
        with profiling.span(self._bridge_spans[n - 1]):
            bottle = getattr(self, f"connect_bridge_list_{n - 1}")(bottle)
        return self.decode(bottle, skips)


class MaskSkipTransUnet(_UnetModel):
    """Skip transformers gated by predicted masks (trans_3DUnet.py:114-147),
    the JAX package's fixed build on its repaired ``Bridge`` (16-wide heads,
    4 layers a bridge). Returns (probabilities, mask_list) in both modes."""

    def __init__(self, num_layers: Sequence[int], dim_input: int, dim_output: int,
                 kernel_size: int = 3, dropout: float = 0.3,
                 dtype: torch.dtype = torch.float32,
                 device: Union[str, torch.device] = "cuda",
                 attention_impl: str = "kernel"):
        super().__init__(num_layers, dim_input, dim_output, kernel_size, dropout)
        self.connect_bridge = Bridge(num_layers, nhead_lens=16)
        self._finish(dtype, device, attention_impl)

    def _forward(self, bottle, skips):
        bottle, trans_skips, mask_list = self.connect_bridge(bottle, skips)
        return self.decode(bottle, trans_skips), mask_list


Model_Dict = {
    "TraditionUnet": TraditionUnet,
    "BottleTransUnet": BottleTransUnet,
    "SkipTransUnet": SkipTransUnet,
    "MaskSkipTransUnet": MaskSkipTransUnet,
    "MaskTransUnet": MaskTransUnet,
}


def get_model_dict(name: str):
    """Registry lookup (trans_3DUnet.py:215-222); an unknown name raises
    ``ValueError``."""
    if name not in Model_Dict:
        raise ValueError(f"unknown model {name!r}; the registry has {tuple(Model_Dict)}")
    return Model_Dict[name]


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


# The flagship, as the JAX package's bench.py and __graft_entry__.py build it:
# five levels 16..256 wide, ROI boxes 100..10 on the four lower levels, 8
# attention layers a bridge, 2 classes.
FLAGSHIP = dict(num_layers=(16, 32, 64, 128, 256), roi_size_list=(100, 65, 40, 25, 10),
                is_roi_list=(False, True, True, True, True), dim_input=1, dim_output=2,
                n_layers=8)


def flagship(seed: int = 0, state: Optional[dict] = None, **kwargs) -> "MaskTransUnet":
    """``MaskTransUnet(**FLAGSHIP)``, ``kwargs`` overriding its widths or
    adding options (``dtype``, ``device``, ...), its parameters ``state`` or
    drawn by ``init_random_`` from a CPU generator seeded with ``seed``."""
    model = MaskTransUnet(**{**FLAGSHIP, **kwargs})
    if state is not None:
        model.load_state_dict(state)
        return model
    return init_random_(model, torch.Generator(device="cpu").manual_seed(seed))
