"""Milliseconds a DDIM step (one batched-CFG UNet eval and the update):
the sum of `synthesize`'s host-clock `sampling_s` over the window's clips
but the profiled one, over their steps."""


def read(record):
    c = [c for c in record["items"]
         if record["kind"] == "i2v" and not c["profiled"]]
    steps = sum(x["steps"] for x in c)
    return 1e3 * sum(x["timings"]["sampling_s"] for x in c) / steps \
        if steps else None
