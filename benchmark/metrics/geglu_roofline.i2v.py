"""The fused GEGLU feed-forward's share of its roofline in the profiled
slice (%): the bound times of the calls the program counted under
`fused_geglu` (ops/fused_geglu; keyed on rows, c, inner, dtype) over the
slice's device time of the class `fused_geglu` (its LN pass and both
GEMMs).

A call's bound is a frozen copy of chip_smoke phase 3's for row 13: x read
and the output written once, the LN vectors, W1, b1, W2 and b2 read once
(2 R c + 3 c inner + 3 c + 2 inner elements, at inner = 4 c the phase's
2 R c + 12 c^2 + 11 c), at 3.35 TB/s, or the two projections' 6 R c inner
operations (24 R c^2) at 989 TFLOP/s in bf16 (165 in fp32 as split TF32);
the larger of the two. A program that counts no such calls gives None."""

from program_spans import recorder

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 495e12 / 3}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(rows, c, inner, dtype) -> float:
    nbytes = ELEMENT_BYTES[dtype] * (2 * rows * c + 3 * c * inner + 3 * c
                                     + 2 * inner)
    return max(nbytes / HBM_BYTES_PER_S,
               6 * rows * c * inner / PEAK_FLOPS[dtype])


def read(record):
    mod = recorder(record)
    if mod is None:
        return None
    calls = mod.counts().get("fused_geglu")
    busy = record["trace"]["by_class_s"].get("fused_geglu")
    if not calls or not busy:
        return None
    return 100.0 * sum(n * bound_s(*key) for key, n in calls.items()) / busy
