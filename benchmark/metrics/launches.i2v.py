"""Device operations (kernels, copies, memsets) a DDIM step: the count in
the profiler's trace of the profiled slice, `trace_steps` whole steps in
the middle of a clip, over those steps."""


def read(record):
    tr = record.get("trace")
    if record["kind"] != "i2v" or not tr or not tr.get("launches"):
        return None
    return tr["launches"] / tr["steps"]
