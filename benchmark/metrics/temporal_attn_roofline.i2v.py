"""The fused temporal attention's share of its roofline in the profiled
slice (%): the bound times (benchmark/rooflines.py) of the calls the program
counted under `fused_temporal` (ops/fused_temporal; keyed on b, t, tokens,
channels, heads, dtype) over the slice's device time of the class
`fused_temporal_attn`."""

from program_spans import roofline


def read(record):
    return roofline(record, "fused_temporal")
