"""Peaks of one NVIDIA H100 SXM (the data sheet, dense) and the least time
a call of one of the port's kernels could take, from its shapes alone.

A call on (BH, N, d) bf16 heads reads q, k and v and writes the output:
4 BH N d elements of 2 bytes, each once; it computes K'^T V and Q' C, two
products of 2 BH N d^2 FLOPs. Its backward reads q, k, v and the output's
gradient and writes dq, dk and dv (7 tensors), and computes the context
again, its gradient, and the three input gradients (5 products). The bound
is the larger of the bytes at the HBM rate and the FLOPs at the bf16 peak.
"""

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2


def attention_bound_s(bh: int, n: int, d: int, backward: bool = False) -> float:
    tensors, products = (7, 5) if backward else (4, 2)
    nbytes = tensors * bh * n * d * BF16_BYTES
    flops = products * 2 * bh * n * d * d
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def attention_bound_total_s(calls, backward: bool = False) -> float:
    """The bound of a list of (BH, N, d) calls, forward (and backward)."""
    total = sum(attention_bound_s(*c) for c in calls)
    if backward:
        total += sum(attention_bound_s(*c, backward=True) for c in calls)
    return total


def call_bound_s(flops: int, nbytes: int) -> float:
    """The least time of a call that must compute ``flops`` and move
    ``nbytes``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS)


def calls_bound_s(calls) -> float:
    """The bound of a list of frozen calls, each {"flops", "bytes", ...}."""
    return sum(call_bound_s(c["flops"], c["bytes"]) for c in calls)


def calls_share(ctx, key: str, kernels) -> float | None:
    """The least time of a serving run's traced windows of the frozen calls
    ``config[key]["window"]`` over the device time of the kernels whose names
    the pattern ``kernels`` finds, in %; None where the run is no serving run,
    the configuration freezes no such calls or no such kernel ran."""
    if ctx.get("kind") != "serve" or key not in ctx["config"]:
        return None
    spent = ctx["trace"].kernel_s(lambda name: kernels.search(name) is not None)
    if spent <= 0:
        return None
    return calls_bound_s(ctx["config"][key]["window"]) * ctx["traced_windows"] / spent * 100


# A transformer stack call: L post-LN linear-attention layers on (B, N, C)
# tokens in eval. A layer's products are the Q, K, V and output projections
# (4 of C x C), the feed-forward (C x 2C and 2C x C), and per head of width
# C / heads the context K'^T V and Q' ctx. It reads the tokens and the f32
# layer weights (A: C x 6C, w2: 2C x C, vecs: 16 x 2C a layer) and writes
# the tokens.


def stack_flops(b: int, n: int, c: int, layers: int, heads: int) -> int:
    return layers * b * n * (16 * c * c + 4 * c * (c // heads))


def stack_bytes(b: int, n: int, c: int, layers: int, token_bytes: int = BF16_BYTES) -> int:
    return 2 * b * n * c * token_bytes + layers * (6 * c * c + 2 * c * c + 32 * c) * 4


# A conv-unit call: a 3x3x3 stride-1 convolution of N volumes of ``voxels``
# with Ca (and Cb, the second input) channels to O, plus bias, the f32 sums
# of the output and its square per (volume, channel). It reads its inputs,
# the weights packed in bf16, the bias and, per input so normalised, the
# (N, 2, C) f32 affine of its prologue; it writes the output and the sums.


def conv_unit_flops(n: int, ca: int, cb: int, out: int, voxels: int) -> int:
    return 2 * n * out * (ca + cb) * 27 * voxels


def conv_unit_bytes(n: int, ca: int, cb: int, out: int, voxels: int, affine_channels: int = 0,
                    act_bytes: int = BF16_BYTES) -> int:
    return (n * (ca + cb + out) * voxels * act_bytes + out * (ca + cb) * 27 * BF16_BYTES
            + out * 4 + n * 2 * affine_channels * 4 + n * 2 * out * 4)
