"""UNet and attention building blocks (``nn.Module``s on ``(N, C, H, W, D)``).

Port of ``lintransunet_tpu/models/blocks.py`` (reference:
``model/Unet_3Dblock.py`` and ``model/trans_block.py``): the flagship's
blocks, and those of the reference's dead paths that the JAX package keeps
(``ConvPosEmbed2d``, ``TransEncoder``, ``Attention3DBlock``, ``SolidBlock``
with its ``BatchNorm``).
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

``dropout_generator`` installs the train step's context: the generator
dropout draws its masks from (the step's, as JAX's step takes ``rng``;
PyTorch's global generator outside it) and the step's data-parallel shard
(rank, size), the one place that says the batch is a shard of a global
one. Two modules read the shard: dropout draws at the global batch's shape,
each rank keeping its own rows, and ``BatchNorm`` takes the global batch's
statistics.

``REMAT`` (``LINTRANSUNET_REMAT``, read once at import, the JAX package's
knob and values): "attn" checkpoints every ``SelfAttentionLayer`` of a
``TransEncoder`` or ``_TokenStack`` in training, so the backward recomputes
each layer's attention and FFN intermediates instead of keeping them
(``attention_layer``). Eval, the fused configuration and the state_dict are
unaffected.

Self-attention projects q, k and v in one product, the JAX package's
``LINTRANSUNET_FUSED_QKV=1`` formulation (exact: the same contractions, the
same parameter tree), and hands its (B, N, 3*C) result to the attention
kernel, which reads the three thirds in place (``MultiheadLinearAttention``).
The fused transformer stack has its own QKV.

A fresh ``Conv3d`` or ``Linear`` initialises as flax's ``nn.Conv`` and
``nn.Dense`` do: ``lecun_normal`` kernels (:func:`lecun_normal_`) and zero
biases.
"""

import contextlib
import contextvars
import math
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from lintransunet_tpu_torch import ops
from lintransunet_tpu_torch.ops import attention, conv_unit, fused_stack
from lintransunet_tpu_torch.ops import linear_attention as fused


# Recompute policy of the training backward (JAX blocks.REMAT): "attn"
# checkpoints every SelfAttentionLayer call; "" keeps every intermediate.
REMAT = os.environ.get("LINTRANSUNET_REMAT", "")

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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` computing in its input's dtype (parameters stay f32),
    initialised as flax's ``nn.Conv``."""

    def reset_parameters(self) -> None:
        _flax_reset(self)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis: batch statistics in
    training (mean and the biased variance E[x^2] - E[x]^2 over every other
    axis, in f32), the running ones in eval; each training call moves the
    running statistics by ``momentum`` as flax does (ra = m ra + (1 - m)
    batch, the biased variance). The running statistics are the buffers
    ``running_mean`` and ``running_var`` (flax's ``batch_stats`` mean and
    var); the output has the input's dtype.

    Under a ``dropout_generator`` shard of size > 1 (a data-parallel step,
    the step context's shard, which dropout reads too) the batch is the
    global one, as under JAX's sharded jit: the ranks sum
    (sum x, sum x^2, count) over the default process group before the mean
    and the variance, through an all-reduce whose backward all-reduces the
    gradient, so each rank's gradient carries every rank's loss through the
    statistics; the running statistics move by the global values."""

    def __init__(self, features: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            dims = tuple(range(x.dim() - 1))
            _, (_, size) = _STEP.get()
            if size == 1:
                mean = xf.mean(dim=dims)
                var = ((xf * xf).mean(dim=dims) - mean * mean).clamp_min(0.0)
            else:
                mean, var = _global_moments(xf, dims)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_((1 - self.momentum) * mean)
                self.running_var.mul_(self.momentum).add_((1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


def _global_moments(xf: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) over ``dims`` of the global batch whose shard
    on this rank is ``xf``: one differentiable all-reduce of (sum x,
    sum x^2, count) over the default process group."""
    from torch.distributed.nn.functional import all_reduce

    c = xf.shape[-1]
    count = xf.new_full((1,), xf.numel() // c)
    sums = all_reduce(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]))
    mean = sums[:c] / sums[-1]
    return mean, (sums[c:2 * c] / sums[-1] - mean * mean).clamp_min(0.0)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with f32 statistics; the output has the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


# The train step's context, (generator, (rank, size)): what dropout draws
# from, and this rank's shard of the global batch, which dropout and
# BatchNorm read (``dropout_generator``)
_STEP = contextvars.ContextVar("dropout_generator", default=(None, (0, 1)))
# The dropout masks of one recomputed call (``attention_layer``): (the list
# its first run appends each mask to, None), or (that list, an iterator over
# it) while the recompute takes them back in order; (None, None) elsewhere
_MASKS = contextvars.ContextVar("recorded_masks", default=(None, None))


@contextlib.contextmanager
def dropout_generator(generator: Optional[torch.Generator],
                      shard: Tuple[int, int] = (0, 1)):
    """The train step's context inside the block: every dropout draws from
    ``generator`` (a ``torch.Generator`` on the activations' device), and
    ``shard`` (rank, size), the step's data-parallel shard, says that the
    activations are rank's rows of a global batch split evenly over size
    ranks. Dropout and ``BatchNorm`` read the shard: each mask is drawn at
    the global batch's shape and rank's rows kept, so that ranks whose
    generators start alike draw together the mask that one process draws
    for the joined batch, as JAX's SPMD step draws the global batch's masks
    once; BatchNorm's statistics are the global batch's, as under JAX's
    sharded jit. (0, 1), one process, runs as it always did."""
    rank, size = shard
    if not 0 <= rank < size:
        raise ValueError(f"shard {shard} is not a (rank, size) pair")
    token = _STEP.set((generator, (rank, size)))
    try:
        yield
    finally:
        _STEP.reset(token)


def dropout(x: torch.Tensor, rate: float, training: bool,
            channel: bool = False) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate and scale by
    1 / (1 - rate), in x's dtype. ``channel`` draws one mask value per
    (N, C) and broadcasts it over the spatial dims (``broadcast_dims`` of
    every spatial axis, torch Dropout3d). Dim 0 of ``x`` is the batch: under
    a ``dropout_generator`` shard the mask is the global batch's rows of
    this rank. A recompute (``attention_layer``) takes back the masks its
    first run drew instead of drawing."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    recorded, replay = _MASKS.get()
    if replay is not None:
        mask = next(replay)
    else:
        generator, (rank, size) = _STEP.get()
        shape = x.shape[:2] + (1,) * (x.dim() - 2) if channel else x.shape
        n = shape[0]
        draw = torch.rand((n * size,) + tuple(shape[1:]), generator=generator, device=x.device)
        mask = draw[rank * n:(rank + 1) * n] < keep
        if recorded is not None:
            recorded.append(mask)
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


class ConvPosEmbed2d(nn.Module):
    """2D twin of the PEG (``Conv2dPosEmbedding``, trans_block.py:99-125; no
    call site in the reference) on (N, C, H, W): residual depthwise k x k
    conv, then channel dropout (Dropout2d: whole channels)."""

    def __init__(self, dim: int, dropout: float, emb_kernel: int = 3):
        super().__init__()
        self.dropout = dropout
        self.proj = Conv2d(dim, dim, emb_kernel, padding=emb_kernel // 2, groups=dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dropout(x + self.proj(x), self.dropout, self.training, channel=True)


class MultiheadLinearAttention(nn.Module):
    """Multi-head O(N) linear attention (``MultihAttention``,
    trans_block.py:127-166). Unmasked calls go through the fused op
    (``attention_impl="kernel"``: the CUDA kernel on the card) or its plain
    version (``"plain"``, which ``MaskTransUnet`` sets to compare the two);
    masked calls take the plain masked op, as in JAX. The reference's
    attention dropout touches only an unused return, so none is applied.

    Self-attention only: every call site, here as in JAX, passes one tensor
    as q, k and v, so ``forward`` takes it once. It runs one ``F.linear``
    with the weights and biases of ``linears_0..2`` concatenated (JAX's
    ``FUSED_QKV`` path, exact); an unmasked kernel call passes the
    (B, N, 3*C) result to ``linear_attention_qkv`` whole (gradient: one
    (B, N, 3*C) tensor), the others take its three head-split thirds
    (``split_qkv``), views all."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model={d_model} is not divisible by nhead={nhead}")
        self.d_model = d_model
        self.nhead = nhead
        self.attention_impl = "kernel"
        for i in range(4):
            self.add_module(f"linears_{i}", Linear(d_model, d_model))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b = x.shape[0]
        projections = [getattr(self, f"linears_{i}") for i in range(3)]
        qkv = F.linear(x, torch.cat([p.weight for p in projections]).to(x.dtype),
                       torch.cat([p.bias for p in projections]).to(x.dtype))
        if mask is not None:
            x = attention.linear_attention(*fused.split_qkv(qkv, self.nhead), mask=mask[:, None])
        elif self.attention_impl == "kernel":
            x = fused.linear_attention_qkv(qkv, self.nhead)
        else:
            x = fused.linear_attention_reference(*fused.split_qkv(qkv, self.nhead))
        return self.linears_3(x.transpose(1, 2).reshape(b, -1, self.d_model))


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
        x = self.layer_norm1(x + drop(self.self_attn(x, mask)))
        h = self.linear2(drop(F.gelu(self.linear1(x))))
        return self.layer_norm2(x + drop(h))


def attention_layer(layer: SelfAttentionLayer, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``layer(x, mask)``, checkpointed in training under ``REMAT == "attn"``.

    The recompute runs inside the backward, outside the step's
    ``dropout_generator`` and, for CUDA tensors, on autograd's own thread.
    So the step's context at this call is carried into it, and the first
    run keeps every dropout mask it draws, which the recompute takes back in
    order instead of drawing: the masks and every generator's stream are
    those of a run without recompute, and no generator's state is read or
    set, which a CUDA graph's capture would refuse (``engine.train``)."""
    if not (layer.training and REMAT == "attn"):
        return layer(x, mask)
    generator, shard = _STEP.get()
    masks = []
    runs = 0

    def run(x, mask):
        nonlocal runs
        replay = iter(masks) if runs else None
        runs += 1
        token = _MASKS.set((masks, replay))
        try:
            with dropout_generator(generator, shard):
                return layer(x, mask)
        finally:
            _MASKS.reset(token)

    return checkpoint(run, x, mask, use_reentrant=False, preserve_rng_state=False)


class TransEncoder(nn.Module):
    """``n_layers`` SelfAttentionLayers (trans_block.py:214-232); the mask,
    if any, reaches every layer's attention."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int,
                 n_layers: int, dropout: float = 0.1):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"layers_{i}", SelfAttentionLayer(
                d_model, nhead, dim_feedforward, dropout))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.n_layers):
            x = attention_layer(getattr(self, f"layers_{i}"), x, mask)
        return x


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
            tokens = attention_layer(getattr(self, f"layers_{i}"), tokens, mask)
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


def _to_tokens_hwd(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W, D) -> (N, H*W*D, C) in (H, W, D) order."""
    n, c = x.shape[:2]
    return x.permute(0, 2, 3, 4, 1).reshape(n, -1, c)


class Attention3DBlock(nn.Module):
    """PEG, tokens in (H, W, D) order, TransEncoder (Unet_3Dblock.py:154-191;
    on no live path of the reference). A mask (N, C', H, W, D) keeps the
    tokens where it is nonzero, through the plain masked attention."""

    def __init__(self, in_dim: int, d_model: int, nhead: int,
                 dropout: float = 0.3, n_layers: int = 8):
        super().__init__()
        self.pos_encode = ConvPosEmbed3d(d_model, dropout)
        self.transformer = TransEncoder(d_model, nhead, 2 * d_model, n_layers, dropout)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        n, c, h, w, d = x.shape
        tokens = _to_tokens_hwd(self.pos_encode(x))
        if mask is not None:
            mask = _to_tokens_hwd(mask) != 0
        tokens = self.transformer(tokens, mask)
        return tokens.reshape(n, h, w, d, c).permute(0, 4, 1, 2, 3)


class SolidBlock(nn.Module):
    """MLP solid-ness head (Unet_3Dblock.py:277-288; on no live path):
    Linear, BatchNorm with running statistics, ReLU, Linear to 1, sigmoid,
    over the last axis."""

    def __init__(self, num_layer: int, inter_num: int = 12):
        super().__init__()
        self.solid_layer_0 = Linear(num_layer, inter_num)
        self.solid_layer_1 = BatchNorm(inter_num)
        self.solid_layer_3 = Linear(inter_num, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.solid_layer_1(self.solid_layer_0(x)))
        return torch.sigmoid(self.solid_layer_3(h))
