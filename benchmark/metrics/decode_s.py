"""Seconds of VAE decode a clip: `synthesize`'s host-clock `decode_s`,
averaged over the window's clips but the profiled one."""


def read(record):
    v = [c["timings"]["decode_s"] for c in record["items"]
         if record["kind"] == "i2v" and not c["profiled"]]
    return sum(v) / len(v) if v else None
