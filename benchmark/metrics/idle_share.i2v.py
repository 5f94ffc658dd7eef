"""The share of the profiled slice in which no operation ran on the device:
1 - (union of the device operations' intervals) / (the slice's length),
both from the trace, with the idle time in which the host was in the
profiler's own work (fetching activity buffers) taken out of the slice.
The profiler still slows each launch on the host, so at a host-paced size
this reads above the untraced share (idle_untraced.i2v)."""


def read(record):
    tr = record.get("trace")
    if record["kind"] != "i2v" or not tr or not tr.get("launches"):
        return None
    window = tr["window_s"] - tr.get("profiler_idle_s", 0.0)
    return 100.0 * (1.0 - tr["busy_s"] / window)
