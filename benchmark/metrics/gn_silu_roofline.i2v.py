"""GroupNorm+SiLU's share of its roofline in the profiled slice (%): the
bound times (benchmark/rooflines.py) of the calls the program counted under
`group_norm_silu` (ops/fused_norms; keyed on the slab's shape, groups,
dtype) over the slice's device time of the class `group_norm_silu` (both
passes)."""

from program_spans import roofline


def read(record):
    return roofline(record, "group_norm_silu")
