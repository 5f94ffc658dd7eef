"""EMA shadow of the trainable parameters (reference LitEma,
lvdm/ema.py:5-75).

Counterpart of open_pandora_tpu/train/ema.py: an fp32 shadow (with bf16
parameters a (1 - 0.9999)-scale step would round away in bf16), decay
ramped in as min(decay, (1 + n) / (10 + n)).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def ema_decay_for_step(step: int, decay: float = 0.9999,
                       warmup: bool = True) -> float:
    """ema.py:29-35, in fp32 as the JAX package computes it."""
    d = np.float32(decay)
    if warmup:
        n = np.float32(step)
        d = min(d, (np.float32(1.0) + n) / (np.float32(10.0) + n))
    return float(d)


class EMA:
    """fp32 shadow copies of `params` (name -> tensor)."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.shadow = {k: p.detach().float().clone()
                       for k, p in params.items()}

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor], step: int,
               decay: float = 0.9999, warmup: bool = True) -> None:
        """s <- s - (1 - d) (s - p) (ema.py:37-52), in fp32."""
        w = float(np.float32(1.0) - np.float32(
            ema_decay_for_step(step, decay, warmup)))
        for k, s in self.shadow.items():
            s.sub_((s - params[k].float()) * w)
