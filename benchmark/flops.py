"""The frozen operation count: `torch.utils.flop_counter.FlopCounterMode`
over the plain reference (benchmark/reference) on the meta device at a
cell's shapes. It counts the products (matmuls, batched matmuls,
convolutions: two operations a multiply-add) of the work as the model
defines it, whatever implements it; recompute is not counted.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from reference import model as ref


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def i2v_parts(config: dict) -> dict:
    """Operations of one image-to-video clip by part: the conditioning (the
    prompt and the empty prompt through the text tower, the image and a
    zero image through ViT-H and the Resampler, the VAE encode of one
    frame), one batched-CFG UNet eval, the decode of every frame."""
    v, u, cv = config["video"], config["unet"], config["clip_vision"]
    h, w, t = v["height"], v["width"], v["frames"]
    n = config["clip_text"]["context_length"]
    ctx_len = u["text_context_len"] + t * u["img_tokens_per_frame"]
    with torch.device("meta"):
        m = ref.DynamiCrafter(config)
        ids = torch.zeros(2, n, dtype=torch.int64)
        img = torch.zeros(2, cv["image_size"], cv["image_size"], 3)
        frame = torch.zeros(1, h, w, 3)
        x = torch.zeros(2, t, h // 8, w // 8, u["out_channels"])
        ts = torch.zeros(2, dtype=torch.int64)
        ctx = torch.zeros(2, ctx_len, u["context_dim"])
        z = torch.zeros(1, t, h // 8, w // 8, u["out_channels"])

        def cond():
            m.encode_text(ids)
            m.image_proj_model(m.embedder.model.visual(img))
            m.encode_frame(frame)

        return {"conditioning": _count(cond),
                "cfg_eval": _count(lambda: m.eps(x, ts, ctx, x, ts)),
                "decode": _count(lambda: m.decode(z))}


def i2v_clip(config: dict) -> int:
    parts = i2v_parts(config)
    return (parts["conditioning"] + config["sampler"]["steps"]
            * parts["cfg_eval"] + parts["decode"])
