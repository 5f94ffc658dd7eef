"""The share of the H100's dense bf16 peak (989 TFLOP/s) that the window's
clips reach: the frozen operation count of a clip (benchmark/flops.py) times
the clips, over their wall time, the profiled clip left out."""


def read(record):
    c = [c for c in record["items"]
         if record["kind"] == "i2v" and not c["profiled"]]
    if not c or not record.get("flops_per_item"):
        return None
    wall = sum(x["wall_s"] for x in c)
    return 100.0 * record["flops_per_item"] * len(c) / wall \
        / record["peak_flops"]
