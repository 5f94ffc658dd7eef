"""Seconds of conditioning a clip (the text and image encoders, the
Resampler, the VAE encode of the frame): `synthesize`'s host-clock
`conditioning_s`, averaged over the window's clips but the profiled one."""


def read(record):
    v = [c["timings"]["conditioning_s"] for c in record["items"]
         if record["kind"] == "i2v" and not c["profiled"]]
    return sum(v) / len(v) if v else None
