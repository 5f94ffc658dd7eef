"""Readers of what the port records about itself in the profiled slice:
the spans and shape-keyed call counts of
`open_pandora_tpu_torch.utils.profiling`, read in this process after the
entry has freed the program (the module outlives it). A program that
records nothing (no such module loaded, or one without `spans` and
`counts`) gives None, as does a record without a profiled slice.
"""

from __future__ import annotations

import sys

import rooflines

MODULE = "open_pandora_tpu_torch.utils.profiling"


def recorder(record: dict):
    """The program's recorder module, where the record holds a profiled
    i2v slice and the program records spans and counts; else None."""
    tr = record.get("trace")
    if record.get("kind") != "i2v" or not tr or not tr.get("launches"):
        return None
    mod = sys.modules.get(MODULE)
    if not (hasattr(mod, "spans") and hasattr(mod, "counts")):
        return None
    return mod


def host_ms(record: dict, names, per: str):
    """Milliseconds of host time in the recorded spans named `names`, over
    the number of recorded `per` spans (each span counted from its start to
    its end stamp)."""
    mod = recorder(record)
    if mod is None:
        return None
    spans = [s for s in mod.spans() if s["end_ns"] is not None]
    n = sum(s["name"] == per for s in spans)
    if not n:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans
               if s["name"] in names) / n / 1e6


def roofline(record: dict, op: str):
    """100 x the bound times of the slice's counted calls of `op`
    (rooflines.py) over the device time of its kernel class in the
    slice."""
    mod = recorder(record)
    if mod is None:
        return None
    bound, cls = rooflines.KERNELS[op]
    calls = mod.counts().get(op)
    busy = record["trace"]["by_class_s"].get(cls)
    if not calls or not busy:
        return None
    return 100.0 * sum(n * bound(*key) for key, n in calls.items()) / busy
