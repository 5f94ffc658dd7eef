"""The small-attention kernel's share of its roofline in the profiled
slice (%): the bound times of the calls the program counted under
`small_attention` (ops/small_attention; keyed on batch, n, m, heads, head
width, dtype) over the slice's device time of the class `small_attn_fwd`.
In the SVD-XT cell it runs the VideoTransformerBlocks' self-attention over
t = 25.

A call's bound is a frozen copy of chip_smoke phase 3's for row 2: q and o
(batch, n, heads d) and k and v (batch, m, heads d) read or written once
at 3.35 TB/s, or the scores and the weighted sum, 4 operations a (query,
key) pair and channel, at 989 TFLOP/s in bf16 (165 in fp32 as split TF32);
the larger of the two. A program that counts no such calls gives None."""

from program_spans import recorder

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(b, n, m, heads, d, dtype) -> float:
    nbytes = ELEMENT_BYTES[dtype] * 2 * b * heads * d * (n + m)
    return max(nbytes / HBM_BYTES_PER_S,
               4 * b * heads * n * m * d / PEAK_FLOPS[dtype])


def read(record):
    mod = recorder(record)
    if mod is None:
        return None
    calls = mod.counts().get("small_attention")
    busy = record["trace"]["by_class_s"].get("small_attn_fwd")
    if not calls or not busy:
        return None
    return 100.0 * sum(n * bound_s(*key) for key, n in calls.items()) / busy
