"""Milliseconds of device work a DDIM step: the union of the device
operations' intervals over the profiled slice, over its steps. The host's
pace does not enter it, so it moves with the kernels alone and stays
steady where the host-paced wall time of a clip spreads."""


def read(record):
    tr = record.get("trace")
    if record["kind"] != "i2v" or not tr or not tr.get("launches"):
        return None
    return 1e3 * tr["busy_s"] / tr["steps"]
