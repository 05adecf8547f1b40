"""Plain forward of the benchmark's models on (N, C, H, W, D) tensors.

A frozen copy of the models' mathematics: ``MaskTransUnet`` (encoder, the
ROI decoder with its mask heads, attention gates, fisheye ROI bridges and
token transformers) and ``BottleTransUnet`` (encoder, one bottleneck
transformer, the plain decoder), with the parameter names of the measured
models so that one state dict loads into both. Every layer computes in the
dtype of its input, which the model sets at its entry: f32 for the
reference. ``fp8_products()`` makes every convolution and dense layer take
its operands rounded to float8 e4m3 with one scale a tensor, the lower
precision of the benchmark's control.
"""

import contextlib
import importlib
import math

import torch
import torch.nn.functional as F
from torch import nn

_FP8 = [False]
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp8_products():
    """Inside, every conv and dense product takes fp8-rounded operands (the
    gradient passes straight through the rounding)."""
    _FP8[0] = True
    try:
        yield
    finally:
        _FP8[0] = False


def _operand(t: torch.Tensor) -> torch.Tensor:
    if not _FP8[0]:
        return t
    scale = t.detach().abs().amax().float().clamp_min(1e-30) / E4M3_MAX
    rounded = ((t.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)
    return t + (rounded - t).detach()


def linear(x, weight, bias):
    return F.linear(_operand(x), _operand(weight.to(x.dtype)), bias.to(x.dtype))


def conv3d(x, weight, bias, stride=1, padding=0, groups=1):
    return F.conv3d(_operand(x), _operand(weight.to(x.dtype)), bias.to(x.dtype), stride,
                    padding, 1, groups)


def instance_norm(x, eps=1e-5):
    """Affine-free, statistics in f32 (single pass E[x^2] - E[x]^2)."""
    x32 = x.float()
    dims = tuple(range(2, x.dim()))
    mean = x32.mean(dim=dims, keepdim=True)
    var = (x32.square().mean(dim=dims, keepdim=True) - mean.square()).clamp_min(0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def norm_act(x):
    return F.leaky_relu(instance_norm(x), 0.01)


# -- dropout: the measured models' law and draw order ------------------------

class Dropout:
    """Where dropout draws: a generator on the activations' device, and the
    block (b, blocks) of a batch of ``blocks`` equal blocks that the
    activations hold. Each mask is ``torch.rand`` in f32 at the whole batch's
    shape, compared with 1 - rate, of which the block keeps its rows, so a
    batch run block by block draws the masks of the batch run at once."""
    generator = None
    block = (0, 1)


def dropout(x, rate, training, channel=False):
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    b, blocks = Dropout.block
    shape = x.shape[:2] + (1,) * (x.dim() - 2) if channel else x.shape
    n = shape[0]
    draw = torch.rand((n * blocks,) + tuple(shape[1:]), generator=Dropout.generator,
                      device=x.device)[b * n:(b + 1) * n]
    return torch.where(draw < keep, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


# -- resampling ---------------------------------------------------------------

def resize_linear(x, scale):
    scale = (scale,) * 3 if isinstance(scale, int) else tuple(scale)
    size = tuple(int(round(s * v)) for s, v in zip(scale, x.shape[2:]))
    if size == tuple(x.shape[2:]):
        return x
    return F.interpolate(x, size=size, mode="trilinear", align_corners=True)


def windows_embedding(img, k=2):
    n, c, h, w, d = img.shape
    x = img.reshape(n, c, h // k, k, w // k, k, d).permute(0, 1, 3, 5, 2, 4, 6)
    return x.reshape(n, c * k * k, h // k, w // k, d)


def windows_unembedding(img, k=2):
    n, c, h, w, d = img.shape
    x = img.reshape(n, c // (k * k), k, k, h, w, d).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(n, c // (k * k), h * k, w * k, d)


def _extent(hist, threshold=0.001):
    """Quantile extent (lo, hi, mid) of (N, L) histograms; an empty one gives
    the centre."""
    hist = hist.float()
    total = hist.sum(dim=-1, keepdim=True)
    centre = hist.shape[-1] / 2.0
    ratio = hist.cumsum(dim=-1) / total
    lo = (ratio < threshold).sum(dim=-1).float()
    hi = (ratio <= 1.0 - threshold).sum(dim=-1).float()
    mid = (ratio <= 0.5).sum(dim=-1).float()
    empty = total[..., 0] == 0
    return (torch.where(empty, centre - 1.0, lo), torch.where(empty, centre + 1.0, hi),
            torch.where(empty, centre, mid))


def _clamp_extent(lo, hi, centre, min_roi, full):
    size = hi - lo
    small = size < min_roi
    lo = torch.where(small, (centre - min_roi / 2.0).clamp_min(0.0), lo)
    hi = torch.where(small, (centre + min_roi / 2.0).clamp_max(full), hi)
    big = size > (full - min_roi)
    lo = torch.where(big, (centre - (full - min_roi) / 2.0).clamp_min(0.0), lo)
    hi = torch.where(big, (centre + (full - min_roi) / 2.0).clamp_max(full), hi)
    return lo, hi


def roi_box(mask, min_h, min_w):
    """(N, H, W, D) mask -> (x0, x1, y0, y1) of the box around it."""
    mask = mask.float()
    _, h, w, _ = mask.shape
    x0, x1, xc = _extent(mask.sum(dim=(2, 3)))
    y0, y1, yc = _extent(mask.sum(dim=(1, 3)))
    x0, x1 = _clamp_extent(x0, x1, xc, float(min_h), float(h))
    y0, y1 = _clamp_extent(y0, y1, yc, float(min_w), float(w))
    return x0, x1, y0, y1


def fisheye(x0, x1, h, roi, eval_roi):
    """Forward fisheye grid, pixel units: (B,) extents -> (B, eval_roi)."""
    x0, x1 = x0.reshape(-1, 1).float(), x1.reshape(-1, 1).float()
    idx = torch.arange(eval_roi, dtype=torch.float32, device=x0.device)[None]
    k2 = (x1 - x0) / (roi - 1)
    k1 = (h - x1 + x0) / (eval_roi - roi)
    out = idx * k2 + x0 * (1 - k2 / k1)
    out = torch.where(out <= x0, out * (k1 / k2) + x0 * (1 - k1 / k2), out)
    return torch.where(out >= x1, out * (k1 / k2) + x1 * (1 - k1 / k2), out)


def fisheye_back(x0, x1, h, roi, eval_roi):
    """Inverse fisheye grid: (B,) extents -> (B, h + 1) in ROI pixels."""
    x0, x1 = x0.reshape(-1, 1).float(), x1.reshape(-1, 1).float()
    idx = torch.arange(int(h) + 1, dtype=torch.float32, device=x0.device)[None]
    k2 = roi / (x1 - x0)
    k1 = (eval_roi - roi) / (h - x1 + x0)
    p0 = x0 * k1
    p1 = eval_roi - (h - x1) * k1
    out = idx * k2 + p0 * (1 - k2 / k1)
    out = torch.where(out <= p0, out * (k1 / k2) + p0 * (1 - k1 / k2), out)
    return torch.where(out >= p1, out * (k1 / k2) + p1 * (1 - k1 / k2), out)


def tent(pix, size):
    grid = torch.arange(size, dtype=torch.float32, device=pix.device)
    return (1.0 - (pix[..., None] - grid).abs()).clamp_min(0.0)


def warp(x, wx, wy):
    """Bilinear warp of every depth slice: rows by wx (N, OH, H), columns by
    wy (N, OW, W)."""
    t = torch.einsum("nih,nchwd->nciwd", wx.to(x.dtype), x)
    return torch.einsum("njw,nciwd->ncijd", wy.to(x.dtype), t)


# -- layers -------------------------------------------------------------------

class Conv3d(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=None, groups=1):
        super().__init__()
        k3 = (k,) * 3
        self.weight = nn.Parameter(torch.empty((cout, cin // groups) + k3))
        self.bias = nn.Parameter(torch.empty(cout))
        self.stride, self.groups = stride, groups
        self.padding = k // 2 if padding is None else padding

    def forward(self, x):
        return conv3d(x, self.weight, self.bias, self.stride, self.padding, self.groups)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def forward(self, x):
        return linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, d, eps):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d))
        self.bias = nn.Parameter(torch.empty(d))
        self.eps = eps

    def forward(self, x):
        return F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                            self.eps).to(x.dtype)


class PosEmbed(nn.Module):
    """Residual depthwise 3x3x3 conv, then channel dropout."""

    def __init__(self, d, rate):
        super().__init__()
        self.rate = rate
        self.proj = Conv3d(d, d, 3, groups=d)

    def forward(self, x):
        return dropout(x + self.proj(x), self.rate, self.training, channel=True)


class LinearAttention(nn.Module):
    """Multi-head linear attention: Q' = softmax over features / sqrt(d),
    K' = softmax over tokens, out = Q' (K'^T V), f32 inside."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        for i in range(4):
            self.add_module(f"linears_{i}", Linear(d_model, d_model))

    def forward(self, x):
        b, n, c = x.shape
        h = self.nhead
        q, k, v = (getattr(self, f"linears_{i}")(x).view(b, n, h, c // h).transpose(1, 2)
                   for i in range(3))
        qs = torch.softmax(q.float(), dim=-1) / math.sqrt(c // h)
        ks = torch.softmax(k.float(), dim=-2)
        out = (qs @ (ks.transpose(-1, -2) @ v.float())).to(x.dtype)
        return self.linears_3(out.transpose(1, 2).reshape(b, n, c))


class AttentionLayer(nn.Module):
    """Post-LN layer: LN(x + drop(attn(x))), LN(x + drop(FFN(x)))."""

    def __init__(self, d, nhead, ff, rate):
        super().__init__()
        self.rate = rate
        self.self_attn = LinearAttention(d, nhead)
        self.layer_norm1 = LayerNorm(d, 1e-6)
        self.linear1 = Linear(d, ff)
        self.linear2 = Linear(ff, d)
        self.layer_norm2 = LayerNorm(d, 1e-6)

    def forward(self, x):
        drop = lambda t: dropout(t, self.rate, self.training)
        x = self.layer_norm1(x + drop(self.self_attn(x)))
        return self.layer_norm2(x + drop(self.linear2(drop(F.gelu(self.linear1(x))))))


class TokenStack(nn.Module):
    """Layers over the (D, H, W)-ordered tokens of a grid, the positional
    conv after layer 0."""

    def __init__(self, d, nhead, rate, n_layers, peg_name):
        super().__init__()
        self.n_layers, self.peg_name = n_layers, peg_name
        for i in range(n_layers):
            self.add_module(f"layers_{i}", AttentionLayer(d, nhead, 2 * d, rate))
        self.add_module(peg_name, PosEmbed(d, rate))

    def forward(self, x):
        n, c, h, w, d = x.shape
        tokens = x.permute(0, 4, 2, 3, 1).reshape(n, d * h * w, c)
        for i in range(self.n_layers):
            tokens = getattr(self, f"layers_{i}")(tokens)
            if i == 0:
                grid = tokens.reshape(n, d, h, w, c).permute(0, 4, 1, 2, 3)
                grid = getattr(self, self.peg_name)(grid)
                tokens = grid.permute(0, 2, 3, 4, 1).reshape(n, d * h * w, c)
        return tokens.reshape(n, d, h, w, c).permute(0, 4, 2, 3, 1)


class ConnectBridge(nn.Module):
    def __init__(self, d, nhead, rate, n_layers):
        super().__init__()
        self.transformer = TokenStack(d, nhead, rate, n_layers, "pos_encoders_0")

    def forward(self, x):
        return self.transformer(x)


class EmbedAttention(TokenStack):
    """Strided-conv embed to d, the token stack, nearest x2 and conv back."""

    def __init__(self, cin, d, nhead, rate, n_layers):
        super().__init__(d, nhead, rate, n_layers, "pos_encoder")
        self.down_embed = nn.Module()
        self.down_embed.add_module("module_list_0_0", Conv3d(cin, d, 3, stride=2, padding=1))
        self.up_embed = nn.Module()
        self.up_embed.add_module("module_list_0_1", Conv3d(d, cin, 3, padding=1))

    def forward(self, x):
        x = dropout(norm_act(self.down_embed.module_list_0_0(x)), self.rate, self.training)
        x = super().forward(x)
        for dim in (2, 3, 4):
            x = x.repeat_interleave(2, dim=dim)
        return dropout(norm_act(self.up_embed.module_list_0_1(x)), self.rate, self.training)

    @property
    def rate(self):
        return self.layers_0.rate


class ROIBridge(nn.Module):
    """Box around the predicted foreground, fisheye warp of the skip into a
    fixed crop, the crop's transformer, the inverse warp."""

    def __init__(self, cin, d, nhead, rate, n_layers, roi):
        super().__init__()
        self.h_roi, self.w_roi = roi, int(roi * 0.6)
        self.eval_h = int(1.2 * roi)
        self.eval_w = int(self.eval_h * 0.6)
        self.transformer = EmbedAttention(cin, d, nhead, rate, n_layers)

    def forward(self, x, mask):
        h, w = x.shape[2], x.shape[3]
        with torch.no_grad():
            x0, x1, y0, y1 = roi_box(mask[:, 0] >= 0.5, self.eval_h // 2, self.eval_w // 2)
        gx = fisheye(x0, x1, h - 1, self.h_roi, self.eval_h)
        gy = fisheye(y0, y1, w - 1, self.w_roi, self.eval_w)
        roi = self.transformer(warp(x, tent(gx, h), tent(gy, w)))
        rh, rw = roi.shape[2], roi.shape[3]
        bx = fisheye_back(x0, x1, h - 1, self.h_roi, self.eval_h) * ((rh - 1) / self.eval_h)
        by = fisheye_back(y0, y1, w - 1, self.w_roi, self.eval_w) * ((rw - 1) / self.eval_w)
        return warp(roi, tent(bx, rh), tent(by, rw))


class AttentionGate(nn.Module):
    def __init__(self, c1, c2, inter):
        super().__init__()
        self.W_x_0 = Conv3d(c1, inter, 1)
        self.W_g_0 = Conv3d(c2, inter, 1)
        self.psi_0 = Conv3d(inter, 1, 1)

    def forward(self, x, up):
        a = instance_norm(self.W_x_0(x)) + instance_norm(self.W_g_0(up))
        return torch.sigmoid(self.psi_0(torch.relu(a)))


class DownBlock(nn.Module):
    def __init__(self, cin, cout, stride, rate):
        super().__init__()
        self.rate = rate
        self.conv1 = Conv3d(cin, cin, 3)
        self.conv2 = Conv3d(cin, cout, 3, stride=stride)

    def forward(self, x):
        y = norm_act(self.conv1(x)) + x
        return dropout(norm_act(self.conv2(y)), self.rate, self.training), y


class UpBlock(nn.Module):
    def __init__(self, cin, cout, rate):
        super().__init__()
        self.rate = rate
        self.conv1 = Conv3d(cin, cout, 3)
        self.conv2 = Conv3d(2 * cout, cout, 3)

    def forward(self, x, skip):
        x = norm_act(self.conv1(x))
        x = norm_act(self.conv2(torch.cat([x, skip], dim=1)))
        return dropout(x, self.rate, self.training)


def encoder_stride(i):
    return (2, 2, (i - 1) % 2 + 1)


def decoder_scale(n, i):
    return (2, 2, 2) if (n - i) % 2 == 0 else (2, 2, 1)


class Encoder(nn.Module):
    def __init__(self, layers, dim_input, rate):
        super().__init__()
        self.n_blocks = len(layers) - 1
        self.input_block = Conv3d(dim_input * 4, layers[0], 3)
        for i in range(1, len(layers)):
            self.add_module(f"block_list_{i - 1}",
                            DownBlock(layers[i - 1], layers[i], encoder_stride(i), rate))

    def forward(self, x):
        x = norm_act(self.input_block(windows_embedding(x)))
        skips = []
        for i in range(self.n_blocks):
            x, skip = getattr(self, f"block_list_{i}")(x)
            skips.append(skip)
        return x, skips


class Decoder(nn.Module):
    """Upsample, UpBlock with the skip, per level; final conv, unembed,
    softmax over classes."""

    def __init__(self, layers, dim_output, rate):
        super().__init__()
        n = self.n = len(layers)
        for i in range(1, n):
            self.add_module(f"block_list_{i - 1}", UpBlock(layers[n - i], layers[n - i - 1], rate))
        self.final_block = Conv3d(layers[0], dim_output * 4, 3)

    def forward(self, x, skips):
        for i in range(1, self.n):
            x = resize_linear(x, decoder_scale(self.n, i))
            x = getattr(self, f"block_list_{i - 1}")(x, skips[-i])
        return torch.softmax(windows_unembedding(self.final_block(x)).float(), dim=1)


class ROIDecoder(nn.Module):
    def __init__(self, layers, roi_sizes, is_roi, dim_output, rate, n_layers):
        super().__init__()
        n = self.n = len(layers)
        self.add_module(f"bridge_list_{n - 1}",
                        ConnectBridge(layers[-1], layers[-1] // 32, rate, n_layers))
        for i in range(1, n):
            level = n - 1 - i
            self.add_module(f"mask_conv_list_{level}", Conv3d(layers[level + 1], dim_output, 3))
            self.add_module(f"att_conv_list_{level}",
                            AttentionGate(layers[level], layers[level + 1], layers[level]))
            if is_roi[level]:
                d = min(4 * layers[level], 256)
                self.add_module(f"bridge_list_{level}", ROIBridge(
                    layers[level], d, d // 32, rate, n_layers, roi_sizes[level]))
            self.add_module(f"block_list_{i - 1}", UpBlock(layers[level + 1], layers[level], rate))
        self.final_block = Conv3d(layers[0], dim_output * 4, 3)

    def forward(self, x, skips):
        """(logits, masks coarse to fine)."""
        n = self.n
        x = getattr(self, f"bridge_list_{n - 1}")(x)
        masks = []
        for i in range(1, n):
            level = n - 1 - i
            x = resize_linear(x, decoder_scale(n, i))
            mask = torch.softmax(getattr(self, f"mask_conv_list_{level}")(x).float(), dim=1)
            masks.append(mask)
            skip = skips[-i]
            skip = skip * getattr(self, f"att_conv_list_{level}")(skip, x).to(skip.dtype)
            bridge = getattr(self, f"bridge_list_{level}", None)
            if bridge is not None:
                skip = bridge(skip, (1.0 - mask[:, 0:1]).to(skip.dtype))
            x = getattr(self, f"block_list_{i - 1}")(x, skip)
        return windows_unembedding(self.final_block(x)), masks


class MaskTransUnet(nn.Module):
    """Training: (class probabilities, mask pyramid). Eval: the class logits."""

    def __init__(self, num_layers, roi_size_list, is_roi_list, dim_input, dim_output,
                 dropout=0.3, n_layers=8, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encode = Encoder(num_layers, dim_input, dropout)
        self.decode = ROIDecoder(num_layers, roi_size_list, is_roi_list, dim_output, dropout,
                                 n_layers)

    def forward(self, x):
        logits, masks = self.decode(*self.encode(x.to(self.dtype)))
        if self.training:
            return torch.softmax(logits.float(), dim=1), masks
        return logits.float()


class BottleTransUnet(nn.Module):
    """Encoder, a 4-layer 8-head bottleneck transformer, the plain decoder;
    class probabilities in both modes."""

    def __init__(self, num_layers, dim_input, dim_output, dropout=0.3, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.encode = Encoder(num_layers, dim_input, dropout)
        self.decode = Decoder(num_layers, dim_output, dropout)
        self.connect_bridge = ConnectBridge(num_layers[-1], 8, dropout, 4)

    def forward(self, x):
        bottle, skips = self.encode(x.to(self.dtype))
        return self.decode(self.connect_bridge(bottle), skips)


MODELS = {"MaskTransUnet": MaskTransUnet, "BottleTransUnet": BottleTransUnet}


def models(config: dict) -> dict:
    """The reference classes a configuration draws from: ``MODELS`` of
    ``portbench/reference/<config["reference"]>.py`` where it names a
    module (plain PyTorch that imports nothing of the port or of JAX; its
    convolutions and dense layers go through this module's ``conv3d`` and
    ``linear`` so that ``fp8_products`` reaches them), else this module's."""
    name = config.get("reference")
    if name is None:
        return MODELS
    if not name.isidentifier():
        raise ValueError(f"configuration {config['name']!r}: reference {name!r} is no module name")
    try:
        module = importlib.import_module(f"portbench.reference.{name}")
    except ModuleNotFoundError as e:
        raise ValueError(f"configuration {config['name']!r}: no reference module "
                         f"portbench/reference/{name}.py") from e
    return module.MODELS


def build(config: dict, dtype=torch.float32, device="cpu") -> nn.Module:
    """The reference model of a benchmark configuration (its ``model`` and
    ``model_kwargs``), parameters uninitialised, on ``device``."""
    registry = models(config)
    if config["model"] not in registry:
        raise ValueError(f"configuration {config['name']!r}: its reference has no model "
                         f"{config['model']!r}, only {sorted(registry)}")
    with torch.device(device):
        return registry[config["model"]](**config["model_kwargs"], dtype=dtype)
