"""Image preprocessing for both towers and the diffusion branch.

Counterpart of open_pandora_tpu/pipeline/preprocess.py, which resizes with
PIL on the host. Here images are NumPy arrays or tensors, uint8 or float in
[0, 1], and the resizes run in torch (bicubic or bilinear, with
antialiasing, on whatever device the tensor is on), so the session needs no
image library. PIL rounds to uint8 after its resize (and so clips the
bicubic overshoot, which this does too); this keeps floats, so the two
agree to about one uint8 step.

  - CLIP ViT-L tower: HF CLIPImageProcessor defaults: shortest edge to 224
    (bicubic), center crop 224, CLIP mean/std.
  - diffusion branch: shortest side to min(h, w) (bilinear), scaled up
    again if the crop box is not covered, center crop, [-1, 1].
  - Resampler image (OpenCLIP ViT-H): [0, 1] at the native size; the model
    resizes and normalises it (models/encoders.clip_preprocess).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def to_unit_float(image, device=None) -> torch.Tensor:
    """uint8 or float (…, H, W, 3) array or tensor -> float32 tensor in
    [0, 1] on `device`."""
    x = (image if torch.is_tensor(image)
         else torch.from_numpy(np.array(image))).to(device)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


def _resize(x: torch.Tensor, size, mode: str = "bilinear") -> torch.Tensor:
    """(…, h, w, 3) -> (…, *size, 3), with antialiasing."""
    lead = x.shape[:-3]
    y = F.interpolate(x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2),
                      size=tuple(size), mode=mode, align_corners=False,
                      antialias=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, *size, 3)


def _shortest_to(h: int, w: int, target: int) -> Tuple[int, int]:
    if w < h:
        return round(h * target / w), target
    return target, round(w * target / h)


def _center_crop(x: torch.Tensor, ch: int, cw: int) -> torch.Tensor:
    h, w = x.shape[-3:-1]
    top, left = max((h - ch) // 2, 0), max((w - cw) // 2, 0)
    return x[..., top:top + ch, left:left + cw, :]


def clip_tower_preprocess(image, size: int = 224, device=None
                          ) -> torch.Tensor:
    """(…, H, W, 3) -> (…, size, size, 3) float32, CLIP-normalized."""
    x = to_unit_float(image, device)
    # bicubic overshoots; an image library clips it when it stores uint8
    x = _resize(x, _shortest_to(*x.shape[-3:-1], size),
                mode="bicubic").clamp(0.0, 1.0)
    x = _center_crop(x, size, size)
    mean = torch.tensor(OPENAI_CLIP_MEAN, device=x.device)
    std = torch.tensor(OPENAI_CLIP_STD, device=x.device)
    return (x - mean) / std


def diffusion_preprocess(image, hw: Tuple[int, int] = (320, 512),
                         device=None) -> torch.Tensor:
    """(…, H, W, 3) -> (…, h, w, 3) float32 in [-1, 1]."""
    h, w = hw
    x = to_unit_float(image, device)
    x = _resize(x, _shortest_to(*x.shape[-3:-1], min(h, w)))
    if x.shape[-3] < h or x.shape[-2] < w:
        scale = max(h / x.shape[-3], w / x.shape[-2])
        x = _resize(x, (round(x.shape[-3] * scale),
                        round(x.shape[-2] * scale)))
    return _center_crop(x, h, w) * 2.0 - 1.0


def clip_resampler_preprocess(image, device=None) -> torch.Tensor:
    """Image for the OpenCLIP ViT-H embedder: [0, 1] float at the native
    size."""
    return to_unit_float(image, device)
