"""The share of an untraced DDIM step in which the device waits: 1 - (the
device's busy time a step, the union of its operations' intervals over
the profiled slice's steps) / (the wall time a step of the window's
unprofiled clips, from `synthesize`'s host-clock `sampling_s`). The
profiler slows the host's launches but not the device's work, so this
reads the idle share of the pace an untraced run keeps."""


def read(record):
    tr = record.get("trace")
    if record["kind"] != "i2v" or not tr or not tr.get("launches"):
        return None
    c = [c for c in record["items"] if not c["profiled"]]
    steps = sum(x["steps"] for x in c)
    if not steps:
        return None
    step_s = sum(x["timings"]["sampling_s"] for x in c) / steps
    return 100.0 * (1.0 - tr["busy_s"] / tr["steps"] / step_s)
