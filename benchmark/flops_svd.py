"""The frozen operation count of an SVD-XT clip:
`torch.utils.flop_counter.FlopCounterMode` over the plain reference
(benchmark/reference/svd.py) on the meta device at the cell's shapes, as
flops.py counts a DynamiCrafter clip: the products (matmuls, batched
matmuls, convolutions; two operations a multiply-add) of the work as the
model defines it, whatever implements it.
"""

from __future__ import annotations

import torch

from flops import _count
from reference import svd as ref


def svd_parts(config: dict) -> dict:
    """Operations of one clip by part: the conditioning (the image through
    ViT-H's pooled readout, the noised frame through the VAE encoder), one
    batched-CFG denoiser eval (both streams, every frame), the decode of
    every frame in chunks of decoding_t."""
    v, u, cv = config["video"], config["video_unet"], config["clip_image"]
    h, w, t = v["height"], v["width"], v["frames"]
    z = config["vae"]["z_channels"]
    f = 2 ** (len(config["vae"]["channel_mult"]) - 1)
    with torch.device("meta"):
        m = ref.SVD(config)
        tower = m.conditioner.embedders["0"].open_clip.model.visual
        img = torch.zeros(1, cv["image_size"], cv["image_size"], 3)
        frame = torch.zeros(1, h, w, 3)
        cond = {"context": torch.zeros(2, 1, u["context_dim"]),
                "concat": torch.zeros(2, h // f, w // f, z),
                "vector": torch.zeros(2, u["adm_in_channels"])}
        x = torch.zeros(2, t, h // f, w // f, z)
        lat = torch.zeros(1, t, h // f, w // f, z)

        def conditioning():
            tower.pooled(img)
            m.encode_frame(frame)

        return {"conditioning": _count(conditioning),
                "cfg_eval": _count(lambda: m.denoise(x, torch.ones(()),
                                                     cond)),
                "decode": _count(lambda: m.decode(lat))}


def svd_clip(config: dict) -> int:
    parts = svd_parts(config)
    return (parts["conditioning"] + config["edm"]["steps"]
            * parts["cfg_eval"] + parts["decode"])
