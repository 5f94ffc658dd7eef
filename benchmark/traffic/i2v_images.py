"""Requests of an image-to-video mix (`generator` "i2v_images"): one client
in a closed loop at batch 1. A request is an RGB image at the
configuration's frame size, smooth at the scale of `image.grid` cells with
`image.detail` of pixel noise, made on the device; a prompt of
`prompt_words` words drawn from `words`; and the seed of the sampler's
generator. Request i comes from (seed, i) alone.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from traffic.generator import np_seed


def smooth_image(gen: torch.Generator, hw, grid, detail: float, device
                 ) -> torch.Tensor:
    """(h, w, 3) float32 in [0, 1]."""
    low = torch.randn(1, 3, *grid, generator=gen, device=device)
    x = F.interpolate(low, size=tuple(hw), mode="bicubic",
                      align_corners=False)
    x = x + detail * torch.randn(x.shape, generator=gen, device=device)
    return torch.sigmoid(x)[0].permute(1, 2, 0)


class Traffic:
    """Requests of one run: `request(i)` for i = 0, 1, ..."""

    def __init__(self, params: dict, config: dict, seed: int, device):
        if (params["loop"], params["clients"], params["batch"]) != (
                "closed", 1, 1):
            raise ValueError("i2v_images serves one client in a closed "
                             "loop at batch 1")
        self.p, self.seed, self.device = params, seed, device
        self.hw = (config["video"]["height"], config["video"]["width"])

    def prompt(self, i: int) -> str:
        rng = np.random.default_rng(np_seed(self.seed, i, 2))
        lo, hi = self.p["prompt_words"]
        n = int(rng.integers(lo, hi + 1))
        return " ".join(rng.choice(self.p["words"], n))

    def image(self, i: int) -> torch.Tensor:
        """The request's image, uint8 (h, w, 3) on the device."""
        gen = torch.Generator(device=self.device).manual_seed(
            np_seed(self.seed, i, 1))
        im = self.p["image"]
        x = smooth_image(gen, self.hw, im["grid"], im["detail"], self.device)
        return (x * 255.0).round().to(torch.uint8)

    def request(self, i: int) -> dict:
        return {"index": i, "image": self.image(i), "prompt": self.prompt(i),
                "noise_seed": np_seed(self.seed, i, 3)}
