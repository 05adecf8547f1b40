"""UNet and attention building blocks (``nn.Module``s on ``(N, C, H, W, D)``).

Port of the live classes of ``lintransunet_tpu/models/blocks.py``
(reference: ``model/Unet_3Dblock.py`` and ``model/trans_block.py``).
Submodule names equal the flax names (``layers_0``, ``self_attn.linears_3``
...), so :func:`lintransunet_tpu_torch.compat.from_flax` gives a state_dict
this port loads as is. Parameters are float32; every layer computes in the
dtype of its input, which the model sets once at its entry (bf16 for the
flagship, as flax ``dtype`` does). Attention tokens are flattened in the
reference's (D, H, W) order.

Two eval-only routes mirror the JAX package's fused configuration
(``MaskTransUnet(fused_s1=True, fused_stack=True)`` sets them): a
``_TokenStack`` with ``fused_stack`` runs its layers through the fused
transformer stack (``ops/fused_stack.py``), and a ``DownBlock`` or
``UpBlock`` with ``fused_s1`` runs its stride-1 convolutions through the
conv unit (``ops/conv_unit.py``), InstanceNorm statistics from the unit's
epilogue, the UpBlock's concat never materialised. Training mode takes
neither (``MaskTransUnet.train()`` refuses them).

Dropout draws its masks from the generator that ``dropout_generator``
installs (the train step's, as JAX's step takes ``rng``), or from PyTorch's
global generator outside it.

A fresh ``Conv3d`` or ``Linear`` initialises as flax's ``nn.Conv`` and
``nn.Dense`` do: ``lecun_normal`` kernels (:func:`lecun_normal_`) and zero
biases.
"""

import contextlib
import contextvars
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lintransunet_tpu_torch import ops
from lintransunet_tpu_torch.ops import attention, conv_unit, fused_stack
from lintransunet_tpu_torch.ops import linear_attention as fused


# flax's variance_scaling "truncated_normal": the std of a standard normal
# cut at +-2, by which the scale is divided so the cut draw keeps its variance
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``lecun_normal()`` in place: a normal of std 1 / sqrt(fan_in) /
    TRUNCATED_STD cut at +-2 of that std, so the draw has variance 1 /
    fan_in. fan_in is everything of a torch weight past its output dim:
    in_features of a dense layer, in_channels / groups times the kernel
    volume of a conv."""
    std = 1.0 / math.sqrt(weight[0].numel()) / TRUNCATED_STD
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _flax_reset(layer: nn.Module) -> None:
    lecun_normal_(layer.weight)
    if layer.bias is not None:
        nn.init.zeros_(layer.bias)


class Conv3d(nn.Conv3d):
    """``nn.Conv3d`` computing in its input's dtype (parameters stay f32),
    initialised as flax's ``nn.Conv``."""

    def reset_parameters(self) -> None:
        _flax_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv3d(x, self.weight, self.bias, self.stride, self.padding,
                          self.groups)


class Linear(nn.Linear):
    """``nn.Linear`` computing in its input's dtype (parameters stay f32),
    initialised as flax's ``nn.Dense``."""

    def reset_parameters(self) -> None:
        _flax_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with f32 statistics; the output has the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


_GENERATOR = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator]):
    """Every dropout inside the block draws from ``generator`` (a
    ``torch.Generator`` on the activations' device)."""
    token = _GENERATOR.set(generator)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def dropout(x: torch.Tensor, rate: float, training: bool,
            channel: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype. ``channel`` draws one mask value per
    (N, C) and broadcasts it over the spatial dims (``broadcast_dims`` of
    every spatial axis, torch Dropout3d)."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channel else x.shape
    mask = torch.rand(shape, generator=_GENERATOR.get(), device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def conv3d_same(in_ch: int, out_ch: int, kernel: int, stride=1,
                groups: int = 1) -> Conv3d:
    """Conv3d with torch 'same'-style symmetric padding k // 2."""
    return Conv3d(in_ch, out_ch, kernel, stride=stride, padding=kernel // 2,
                  groups=groups)


class ConvPosEmbed3d(nn.Module):
    """Residual depthwise-conv positional encoding + channel dropout
    (``Conv3dPosEmbedding``, trans_block.py:70-96)."""

    def __init__(self, dim: int, dropout: float, emb_kernel: int = 3):
        super().__init__()
        self.dropout = dropout
        self.proj = conv3d_same(dim, dim, emb_kernel, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x + self.proj(x), self.dropout, self.training, channel=True)


class MultiheadLinearAttention(nn.Module):
    """Multi-head O(N) linear attention (``MultihAttention``,
    trans_block.py:127-166). Unmasked calls go through the fused op
    (``attention_impl="kernel"``: the CUDA kernel on the card) or its plain
    version (``"plain"``, which ``MaskTransUnet`` sets to compare the two);
    masked calls take the plain masked op, as in JAX. The reference's
    attention dropout touches only an unused return, so none is applied."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model={d_model} is not divisible by nhead={nhead}")
        self.d_model = d_model
        self.nhead = nhead
        self.attention_impl = "kernel"
        for i in range(4):
            self.add_module(f"linears_{i}", Linear(d_model, d_model))

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = q.shape[0]
        d_k = self.d_model // self.nhead

        def split(t):  # (B, N, C) -> (B, H, N, d_k), contiguous for the kernel
            return t.reshape(b, -1, self.nhead, d_k).transpose(1, 2).contiguous()

        q, k, v = (split(getattr(self, f"linears_{i}")(t))
                   for i, t in enumerate((q, k, v)))
        if mask is not None:
            x = attention.linear_attention(q, k, v, mask=mask[:, None])
        elif self.attention_impl == "kernel":
            x = fused.linear_attention(q, k, v)
        else:
            x = fused.linear_attention_reference(q, k, v)
        x = x.transpose(1, 2).reshape(b, -1, self.d_model)
        return self.linears_3(x)


class SelfAttentionLayer(nn.Module):
    """Post-LN encoder layer (trans_block.py:169-211): LayerNorm(eps 1e-6)
    after each residual add; FFN Linear -> exact-erf GELU -> Linear."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiheadLinearAttention(d_model, nhead)
        self.layer_norm1 = LayerNorm(d_model, eps=1e-6)
        self.linear1 = Linear(d_model, dim_feedforward)
        self.linear2 = Linear(dim_feedforward, d_model)
        self.layer_norm2 = LayerNorm(d_model, eps=1e-6)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        drop = lambda t: dropout(t, self.dropout, self.training)
        x = self.layer_norm1(x + drop(self.self_attn(x, x, x, mask)))
        h = self.linear2(drop(F.gelu(self.linear1(x))))
        return self.layer_norm2(x + drop(h))


def to_tokens_dhw(x: torch.Tensor) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """(N, C, H, W, D) -> (N, D*H*W, C) in the reference's (D, H, W) order."""
    n, c, h, w, d = x.shape
    return x.permute(0, 4, 2, 3, 1).reshape(n, d * h * w, c), (h, w, d)


def from_tokens_dhw(t: torch.Tensor, hwd: Tuple[int, int, int]) -> torch.Tensor:
    h, w, d = hwd
    n, _, c = t.shape
    return t.reshape(n, d, h, w, c).permute(0, 4, 2, 3, 1)


def peg_on_tokens(tokens: torch.Tensor, hwd: Tuple[int, int, int],
                  peg: ConvPosEmbed3d) -> torch.Tensor:
    """Apply a PEG to (D, H, W)-ordered tokens: the reference convolves a
    (D, H, W) grid, so the kernel's first axis runs over depth
    (Unet_3Dblock.py:265-270)."""
    h, w, d = hwd
    n, _, c = tokens.shape
    grid = peg(tokens.reshape(n, d, h, w, c).permute(0, 4, 1, 2, 3))
    return grid.permute(0, 2, 3, 4, 1).reshape(n, d * h * w, c)


class _TokenStack(nn.Module):
    """``n_layers`` SelfAttentionLayers over the tokens of a 3D grid with the
    PEG re-injected after layer 0 (the unfused loop of blocks.py:377-390).

    ``fused_stack`` (eval, no mask): layer 0 and layers 1..L-1 run as two
    fused-stack calls around the PEG (JAX ``_fused_layer_stack``), on the
    same (D, H, W)-ordered tokens: linear attention does not depend on the
    order of its tokens, so the JAX route's (H, W, D) order is not needed."""

    fused_stack = False

    def _add_layers(self, d_model, nhead, dropout, n_layers, peg_name):
        self.n_layers = n_layers
        self.peg_name = peg_name
        for i in range(n_layers):
            self.add_module(f"layers_{i}", SelfAttentionLayer(
                d_model, nhead, 2 * d_model, dropout))
        self.add_module(peg_name, ConvPosEmbed3d(d_model, dropout))

    def _run_layers(self, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        tokens, hwd = to_tokens_dhw(x)
        if self.fused_stack and not self.training and mask is None:
            return from_tokens_dhw(self._fused_layers(tokens, hwd), hwd)
        if mask is not None:
            mask = to_tokens_dhw(mask)[0] != 0
        for i in range(self.n_layers):
            tokens = getattr(self, f"layers_{i}")(tokens, mask)
            if i == 0:
                tokens = peg_on_tokens(tokens, hwd, getattr(self, self.peg_name))
        return from_tokens_dhw(tokens, hwd)

    def _fused_layers(self, tokens: torch.Tensor,
                      hwd: Tuple[int, int, int]) -> torch.Tensor:
        layers = [getattr(self, f"layers_{i}") for i in range(self.n_layers)]
        nhead = layers[0].self_attn.nhead
        tokens = fused_stack.fused_transformer_stack(
            tokens.contiguous(), *fused_stack.stack_layer_params(layers[:1]), nhead)
        tokens = peg_on_tokens(tokens, hwd, getattr(self, self.peg_name))
        if len(layers) > 1:
            tokens = fused_stack.fused_transformer_stack(
                tokens.contiguous(), *fused_stack.stack_layer_params(layers[1:]),
                nhead)
        return tokens


class PosAttention3DBlock(_TokenStack):
    """Token transformer over a 3D feature map (Unet_3Dblock.py:224-274);
    only the reference's ``pos_encoders_0`` is ever used, so only it exists."""

    def __init__(self, in_dim: int, d_model: int, nhead: int,
                 dropout: float = 0.3, n_layers: int = 8):
        super().__init__()
        self._add_layers(d_model, nhead, dropout, n_layers, "pos_encoders_0")

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self._run_layers(x, mask)


class SpatialAttentionGate(nn.Module):
    """Additive attention gate (``SpatialAttention3DBlock``,
    Unet_3Dblock.py:194-221): sigmoid(psi(relu(IN(Wx skip) + IN(Wg up))))."""

    def __init__(self, in_channel1: int, in_channel2: int, inter_channel: int):
        super().__init__()
        self.W_x_0 = Conv3d(in_channel1, inter_channel, 1)
        self.W_g_0 = Conv3d(in_channel2, inter_channel, 1)
        self.psi_0 = Conv3d(inter_channel, 1, 1)

    def forward(self, x: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
        a = ops.instance_norm(self.W_x_0(x)) + ops.instance_norm(self.W_g_0(up))
        return torch.sigmoid(self.psi_0(torch.relu(a)))


def _norm_act(x: torch.Tensor) -> torch.Tensor:
    return ops.leaky_relu(ops.instance_norm(x))


def _voxels(x: torch.Tensor) -> int:
    return x.shape[2] * x.shape[3] * x.shape[4]


def fused_conv_norm_act(x: torch.Tensor, conv: Conv3d) -> torch.Tensor:
    """``_norm_act(conv(x))`` for a 3x3x3 stride-1 conv through the conv
    unit: the InstanceNorm statistics come from its epilogue."""
    y, stats = conv_unit.conv_unit(x.contiguous(), conv.weight, bias=conv.bias)
    return conv_unit.apply_affine_leaky(
        y, *conv_unit.stats_to_affine(stats, _voxels(y)))


class DownBlock(nn.Module):
    """Residual conv + strided-conv downsample (Unet_3Dblock.py:290-341).
    Returns (downsampled, pre-downsample skip). ``fused_s1`` (eval): conv1
    runs through the conv unit (JAX ``PackedDownBlock``'s fused chain);
    the strided conv2 stays on ``F.conv3d``."""

    fused_s1 = False

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride=(2, 2, 2),
                 dropout: Optional[float] = None, is_res: bool = True):
        super().__init__()
        self.dropout = dropout
        self.is_res = is_res
        self.conv1 = conv3d_same(in_channels, in_channels, kernel_size)
        self.conv2 = conv3d_same(in_channels, out_channels, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.fused_s1 and not self.training:
            y = fused_conv_norm_act(x, self.conv1)
        else:
            y = _norm_act(self.conv1(x))
        if self.is_res:
            y = y + x
        z = _norm_act(self.conv2(y))
        if self.dropout is not None:
            z = dropout(z, self.dropout, self.training)
        return z, y


class UpBlock(nn.Module):
    """Conv, concat (x, skip) on channels, conv (Unet_3Dblock.py:504-557).
    The decoder upsamples before calling it. ``fused_s1`` (eval): two conv
    units as JAX ``PackedUpBlock``'s fused chain; conv1's InstanceNorm +
    LeakyReLU rides conv2's prologue, and conv2 takes x and the skip as two
    inputs with its weight split by input channels, x's first."""

    fused_s1 = False

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.conv1 = conv3d_same(in_channels, out_channels, kernel_size)
        self.conv2 = conv3d_same(2 * out_channels, out_channels, kernel_size)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        if self.fused_s1 and not self.training:
            x = self._fused(x, skip)
        else:
            x = _norm_act(self.conv1(x))
            x = _norm_act(self.conv2(torch.cat([x, skip], dim=1)))
        if self.dropout is not None:
            x = dropout(x, self.dropout, self.training)
        return x

    def _fused(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        y1, stats1 = conv_unit.conv_unit(x.contiguous(), self.conv1.weight,
                                         bias=self.conv1.bias)
        c = y1.shape[1]
        w = self.conv2.weight
        y2, stats2 = conv_unit.conv_unit(
            y1, w[:, :c], xb=skip.contiguous(), wb=w[:, c:], bias=self.conv2.bias,
            affine_a=torch.stack(conv_unit.stats_to_affine(stats1, _voxels(y1)), dim=1))
        return conv_unit.apply_affine_leaky(
            y2, *conv_unit.stats_to_affine(stats2, _voxels(y2)))


def _embed_channel_list(in_channels: int, out_channels: int, times: int,
                        up: bool):
    """Channel schedules of Down/UpEmbedBlock (Unet_3Dblock.py:362-363, 408-409)."""
    if up:
        chans = [out_channels // (2 ** i) if out_channels // (2 ** i) >= in_channels
                 else out_channels for i in range(times + 1)]
        chans[-1] = in_channels
    else:
        chans = [in_channels * (2 ** i) if in_channels * (2 ** i) <= out_channels
                 else out_channels for i in range(times + 1)]
        chans[-1] = out_channels
    return chans


class DownEmbedBlock(nn.Module):
    """Strided-conv channel-raising embed (Unet_3Dblock.py:343-385)."""

    def __init__(self, in_channels: int, out_channels: int, down_times: int,
                 kernel_size: int = 3, stride: int = 2,
                 dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.down_times = down_times
        chans = _embed_channel_list(in_channels, out_channels, down_times, up=False)
        for i in range(down_times):
            self.add_module(f"module_list_{i}_0", Conv3d(
                chans[i], chans[i + 1], kernel_size, stride=stride, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.down_times):
            x = _norm_act(getattr(self, f"module_list_{i}_0")(x))
            if self.dropout is not None:
                x = dropout(x, self.dropout, self.training)
        return x


class UpEmbedBlock(nn.Module):
    """Nearest upsample + conv inverse of DownEmbedBlock
    (Unet_3Dblock.py:388-432)."""

    def __init__(self, in_channels: int, out_channels: int, down_times: int,
                 kernel_size: int = 3, stride: int = 2,
                 dropout: Optional[float] = None):
        super().__init__()
        self.dropout = dropout
        self.down_times = down_times
        self.stride = stride
        chans = _embed_channel_list(in_channels, out_channels, down_times, up=True)
        for i in range(down_times):
            self.add_module(f"module_list_{i}_1", Conv3d(
                chans[i], chans[i + 1], kernel_size, padding=1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.down_times):
            x = ops.resize_nearest(x, self.stride)
            x = _norm_act(getattr(self, f"module_list_{i}_1")(x))
            if self.dropout is not None:
                x = dropout(x, self.dropout, self.training)
        return x


class EmbedAttention3DBlock(_TokenStack):
    """Down-embed -> n_layers linear-attention layers (PEG after layer 0) ->
    up-embed (Unet_3Dblock.py:435-501): the transformer of every ROI crop."""

    def __init__(self, in_dim: int, d_model: int, nhead: int,
                 dropout: float = 0.3, n_layers: int = 8):
        super().__init__()
        self.down_embed = DownEmbedBlock(in_dim, d_model, 1, dropout=dropout)
        self._add_layers(d_model, nhead, dropout, n_layers, "pos_encoder")
        self.up_embed = UpEmbedBlock(in_dim, d_model, 1, dropout=dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.up_embed(self._run_layers(self.down_embed(x)))
