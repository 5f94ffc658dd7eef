"""Normalization with fp32 statistics, channel-last (..., C).

Counterpart of open_pandora_tpu/ops/norms.py. The eps differs by site:
1e-5 in the UNet ResBlocks and temporal conv blocks, 1e-6 in the transformer
GroupNorms and the VAE, 1e-5 in LayerNorms.
"""

from __future__ import annotations

from typing import Optional

import torch


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               silu: bool = False) -> torch.Tensor:
    """GroupNorm over channel-last x (N, ..., C): statistics per sample over
    every middle dim and the channels of a group, in fp32; optional SiLU."""
    c = x.shape[-1]
    xf = x.float().reshape(x.shape[0], -1, num_groups, c // num_groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    xf = (xf - mean) / torch.sqrt(var + eps)
    out = xf.reshape(x.shape) * weight.float() + bias.float()
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor], *, eps: float = 1e-5
               ) -> torch.Tensor:
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mean) / torch.sqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
