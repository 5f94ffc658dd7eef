"""The least time the card could take for one call of each of the port's
own kernels that the program counts by shape: a frozen copy of
`chip_smoke.bound_ms`'s arithmetic (each input read once and each output
written once at 3.35 TB/s, or the operations at the dense tensor-core peak:
989 TFLOP/s in bf16, 495 / 3 = 165 in fp32 as split TF32; the larger of
the two), per kernel as chip_smoke's phase 3 counts its work, so that a
later change to the program does not move the yardstick.

Each function takes the key the program counts a call under
(`open_pandora_tpu_torch.utils.profiling.count`) and returns seconds.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def packed_attention(b, n, heads, d, ms, dtype) -> float:
    """q and o (b, n, heads d) and one or two key/value streams of ms[s]
    rows: every (query, key) pair scored and summed, 4 operations a pair and
    channel."""
    hd, m = heads * d, sum(ms)
    return bound_s(ELEMENT_BYTES[dtype] * (2 * b * n * hd + 2 * b * hd * m),
                   4 * b * n * m * hd, dtype)


def group_norm_silu(shape, groups, dtype) -> float:
    """The slab read and written once, weight and bias read."""
    numel, c = math.prod(shape), shape[-1]
    return bound_s(ELEMENT_BYTES[dtype] * (2 * numel + 2 * c), 8 * numel,
                   dtype)


def fused_temporal(b, t, tokens, c, heads, dtype) -> float:
    """LN, the four c x c projections and the t x t attention of every
    (b, token) row: y read and written, the four weights and three vectors
    read."""
    rows = b * t * tokens
    return bound_s(ELEMENT_BYTES[dtype] * (2 * rows * c + 4 * c * c + 3 * c),
                   8 * rows * c * c + 4 * rows * t * c, dtype)


# the op the program counts -> (its call's bound, its kernel class in
# benchmark/kernel_classes.py)
KERNELS = {"packed_attention": (packed_attention, "packed_attn_fwd"),
           "group_norm_silu": (group_norm_silu, "group_norm_silu"),
           "fused_temporal": (fused_temporal, "fused_temporal_attn")}
