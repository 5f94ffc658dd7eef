"""Packed attention's share of its roofline in the profiled slice (%): the
bound times (benchmark/rooflines.py) of the calls the program counted under
`packed_attention` (ops/packed_attention, both regimes; keyed on b, n,
heads, d, each stream's key rows, dtype) over the slice's device time of
the class `packed_attn_fwd`."""

from program_spans import roofline


def read(record):
    return roofline(record, "packed_attention")
