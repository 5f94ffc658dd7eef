"""Parameter-holding layers shared by the models, channel-last.

Each keeps the parameter names and shapes of its torch counterpart in the
reference state dict (nn.Conv2d OIHW weights, norm `weight`/`bias`), while
taking and returning channel-last activations as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
from open_pandora_tpu_torch.ops.norms import group_norm, layer_norm


class Conv2d(nn.Conv2d):
    """nn.Conv2d over (N, H, W, C). The permutes are views: the convolution
    sees a channels-last NCHW tensor and returns one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PointwiseConv(nn.Module):
    """A kernel-size-1 convolution as a matmul over the channel axis. The
    weight keeps the convolution's shape: (out, in, 1[, 1])."""

    def __init__(self, in_ch: int, out_ch: int, spatial_dims: int = 2,
                 bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch,
                                               *([1] * spatial_dims)))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.reshape(self.weight.shape[:2]),
                        self.bias)


class GroupNorm32(nn.Module):
    """GroupNorm(32) with fp32 statistics over channel-last input. In eval,
    bf16 activations route through fused_group_norm_silu (the GroupNorm+SiLU
    kernel on a CUDA device); training takes the plain version, since the
    kernel is forward-only."""

    def __init__(self, channels: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, silu: bool = False) -> torch.Tensor:
        if self.training:
            return group_norm(x, self.weight, self.bias, num_groups=32,
                              eps=self.eps, silu=silu)
        return fused_group_norm_silu(x.contiguous(), self.weight, self.bias,
                                     num_groups=32, eps=self.eps, silu=silu)


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, eps=self.eps)


def nearest_up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of (N, H, W, C)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
