"""Peaks of one NVIDIA H100 SXM (the data sheet, dense) and the least time
a linear-attention call could take, from its shapes alone.

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
