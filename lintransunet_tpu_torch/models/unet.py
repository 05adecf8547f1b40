"""Encoder and decoders (``nn.Module``s, ``(N, C, H, W, D)``).

Port of the unpacked path of ``lintransunet_tpu/models/unet.py``
(reference: Unet_3Dblock.py:560-644, 1277-1424): the encoder, the
flagship's ROI decoder, the plain ``Decoder`` of the other models and the
``MaskDecoder``. The JAX package's packed,
folded and paired layouts compute the same functions for the TPU's lanes
and are not ported. Depth schedule: encoder block i (1-based) strides
``(2, 2, (i-1) % 2 + 1)``; the decoder mirrors it with alternating
``(2, 2, 2)`` / ``(2, 2, 1)`` trilinear upsamples.

Each level runs in a profiler span of its own (``utils.profiling.span``):
``encoder.embed``, ``encoder.level<i>``, ``decoder.level<i>`` (each ROI
bridge inside it as ``bridge.level<i>``, the bottleneck bridge as
``bridge.level<L-1>``) and ``decoder.head``.

``fused_s1_levels`` is the port's counterpart of the JAX ``packed_levels``
with ``LINTRANSUNET_FUSED_S1=1``: at eval, the stride-1 convolutions of the
top levels (the input block, the first DownBlocks' conv1, the last
UpBlocks) run through the conv unit (``ops/conv_unit.py``).
"""

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from lintransunet_tpu_torch import ops
from lintransunet_tpu_torch.models.blocks import (
    DownBlock,
    SpatialAttentionGate,
    UpBlock,
    conv3d_same,
    fused_conv_norm_act,
)
from lintransunet_tpu_torch.models.bridges import ConnectBridge, InitialBridge, ROIBridge
from lintransunet_tpu_torch.utils import profiling


def encoder_stride(i: int) -> Tuple[int, int, int]:
    """Stride of encoder block i (1-based), Unet_3Dblock.py:584."""
    return (2, 2, (i - 1) % 2 + 1)


def decoder_scale(n_levels: int, i: int) -> Tuple[int, int, int]:
    """Upsample factor at decoder step i (1-based), Unet_3Dblock.py:1375-1378."""
    return (2, 2, 2) if (n_levels - i) % 2 == 0 else (2, 2, 1)


class Encoder(nn.Module):
    """2x2 window embed -> input conv -> anisotropic DownBlocks. Returns
    (bottleneck, [skip_0 .. skip_{L-2}]). With ``fused_s1_levels`` = p > 0
    (capped at L - 2, as JAX caps ``packed_levels``), the input block and
    DownBlocks 1..p run their stride-1 convs through the conv unit at eval."""

    def __init__(self, num_layers: Sequence[int], dim_input: int,
                 kernel_size: int = 3, dropout: Optional[float] = None,
                 emb_window: int = 2, fused_s1_levels: int = 0):
        super().__init__()
        self.num_layers = tuple(num_layers)
        self.emb_window = emb_window
        self.input_block = conv3d_same(dim_input * emb_window ** 2,
                                       num_layers[0], kernel_size)
        levels = min(fused_s1_levels, len(num_layers) - 2) if kernel_size == 3 else 0
        self.fused_s1 = levels > 0
        for i in range(1, len(num_layers)):
            block = DownBlock(num_layers[i - 1], num_layers[i], kernel_size,
                              encoder_stride(i), dropout)
            block.fused_s1 = i <= levels
            self.add_module(f"block_list_{i - 1}", block)
        self._spans = [f"encoder.level{i}" for i in range(1, len(num_layers))]

    def forward(self, x: torch.Tensor, dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """``dtype``: the compute dtype the input is cast to first (the
        model's)."""
        n_blocks = len(self.num_layers) - 1
        hw_div = self.emb_window * 2 ** n_blocks
        d_div = 2 ** sum(encoder_stride(i)[2] == 2 for i in range(1, n_blocks + 1))
        h, w, d = x.shape[2:]
        if h % hw_div or w % hw_div or d % d_div:
            raise ValueError(
                f"input spatial dims (H={h}, W={w}, D={d}) must be divisible "
                f"by ({hw_div}, {hw_div}, {d_div}) for {n_blocks} encoder "
                f"levels with window embedding {self.emb_window}")
        with profiling.span("encoder.embed"):
            if dtype is not None:
                x = x.to(dtype)
            x = ops.windows_embedding(x, self.emb_window)
            if self.fused_s1 and not self.training:
                x = fused_conv_norm_act(x, self.input_block)
            else:
                x = ops.leaky_relu(ops.instance_norm(self.input_block(x)))
        skips = []
        for i in range(n_blocks):
            with profiling.span(self._spans[i]):
                x, skip = getattr(self, f"block_list_{i}")(x)
            skips.append(skip)
        return x, skips


class Decoder(nn.Module):
    """Plain mirror decoder, final conv, window unembed and channel softmax
    (Unet_3Dblock.py:610-644) of ``TraditionUnet`` and the skip / bottleneck
    transformer models. The JAX package's flagged deviation is kept: the
    reference never upsamples inside its UpBlocks, which makes their skip
    concat shape-inconsistent, so a trilinear upsample mirroring the encoder
    strides runs before each UpBlock, and the window unembedding brings the
    output back to full resolution."""

    def __init__(self, num_layers: Sequence[int], dim_output: int,
                 kernel_size: int = 3, dropout: Optional[float] = None,
                 emb_window: int = 2):
        super().__init__()
        layers = list(num_layers)
        n = len(layers)
        self.n_levels = n
        self.emb_window = emb_window
        for i in range(1, n):
            self.add_module(f"block_list_{i - 1}", UpBlock(
                layers[n - i], layers[n - i - 1], kernel_size, dropout))
        self.final_block = conv3d_same(layers[0], dim_output * emb_window ** 2,
                                       kernel_size)
        self._spans = [f"decoder.level{n - 1 - i}" for i in range(1, n)]

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        n = self.n_levels
        for i in range(1, n):
            with profiling.span(self._spans[i - 1]):
                x = ops.resize_linear_align_corners(x, decoder_scale(n, i))
                x = getattr(self, f"block_list_{i - 1}")(x, skips[-i])
        with profiling.span("decoder.head"):
            x = ops.windows_unembedding(self.final_block(x), self.emb_window)
            return torch.softmax(x.float(), dim=1)


class MaskDecoder(nn.Module):
    """Mask-pyramid upsampler (Unet_3Dblock.py:1399-1424; on no live path):
    mask j levels above the finest is upsampled (2^(j+1), 2^(j+1),
    2^(j // 2)). No parameters."""

    def __init__(self, num_layers: Sequence[int]):
        super().__init__()
        self.n_levels = len(num_layers)

    def forward(self, mask_list: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        n = self.n_levels
        if len(mask_list) != n - 1:
            raise ValueError(f"MaskDecoder of {n} levels takes {n - 1} masks, "
                             f"not {len(mask_list)}")
        out = []
        for i, mask in enumerate(mask_list):
            j = n - 2 - i
            out.append(ops.resize_linear_align_corners(
                mask, (2 ** (j + 1), 2 ** (j + 1), 2 ** (j // 2))))
        return out


class ROIDecoder(nn.Module):
    """The live decoder (Unet_3Dblock.py:1277-1396). Per level, bottleneck
    up: trilinear upsample -> mask head (softmax, deep supervision) ->
    attention-gate the skip -> ROIBridge(gated skip, foreground) -> UpBlock.
    Then the final conv, window unembed and (optionally) channel softmax.
    Returns (out, mask_list), mask_list ordered coarse -> fine. The UpBlocks
    of levels below ``fused_s1_levels`` (capped at L - 2) run through the
    conv unit at eval."""

    def __init__(self, num_layers: Sequence[int], roi_size_list: Sequence[int],
                 is_roi_list: Sequence[bool], dim_output: int,
                 kernel_size: int = 3, nhead_lens: int = 32,
                 dropout: float = 0.2, n_layers: int = 8, emb_window: int = 2,
                 fused_s1_levels: int = 0):
        super().__init__()
        layers = list(num_layers)
        n = len(layers)
        fused_levels = min(fused_s1_levels, n - 2) if kernel_size == 3 else 0
        self.n_levels = n
        self.emb_window = emb_window
        self.add_module(f"bridge_list_{n - 1}", ConnectBridge(
            layers[-1], layers[-1] // nhead_lens, dropout, n_layers))
        for i in range(1, n):
            level = n - 1 - i
            self.add_module(f"mask_conv_list_{level}", conv3d_same(
                layers[level + 1], dim_output, kernel_size))
            self.add_module(f"att_conv_list_{level}", SpatialAttentionGate(
                layers[level], layers[level + 1], layers[level]))
            if is_roi_list[level]:
                d_model = min(4 * layers[level], 256)
                bridge = ROIBridge(layers[level], d_model, d_model // 32,
                                   dropout, n_layers, roi_size_list[level])
            else:
                bridge = InitialBridge()
            self.add_module(f"bridge_list_{level}", bridge)
            block = UpBlock(layers[level + 1], layers[level], kernel_size, dropout)
            block.fused_s1 = level < fused_levels
            self.add_module(f"block_list_{i - 1}", block)
        self.final_block = conv3d_same(layers[0], dim_output * emb_window ** 2,
                                       kernel_size)
        self._spans = [f"decoder.level{level}" for level in range(n - 1)]
        # the identity bridges get no span
        self._bridge_spans = [f"bridge.level{level}" if level == n - 1 or is_roi_list[level]
                              else None for level in range(n)]

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor],
                apply_softmax: bool = True):
        n = self.n_levels
        with profiling.span(self._bridge_spans[n - 1]):
            x = getattr(self, f"bridge_list_{n - 1}")(x)
        mask_list = []
        for i in range(1, n):
            level = n - 1 - i
            with profiling.span(self._spans[level]):
                x = ops.resize_linear_align_corners(x, decoder_scale(n, i))
                mask = torch.softmax(
                    getattr(self, f"mask_conv_list_{level}")(x).float(), dim=1)
                mask_list.append(mask)
                skip = skips[-i]
                gate = getattr(self, f"att_conv_list_{level}")(skip, x)
                skip = skip * gate.to(skip.dtype)
                foreground = (1.0 - mask[:, 0:1]).to(skip.dtype)
                bridge = getattr(self, f"bridge_list_{level}")
                if self._bridge_spans[level] is None:
                    bridged = bridge(skip, foreground)
                else:
                    with profiling.span(self._bridge_spans[level]):
                        bridged = bridge(skip, foreground)
                x = getattr(self, f"block_list_{i - 1}")(x, bridged)
        with profiling.span("decoder.head"):
            x = ops.windows_unembedding(self.final_block(x), self.emb_window)
            if apply_softmax:
                x = torch.softmax(x.float(), dim=1)
        return x, mask_list
