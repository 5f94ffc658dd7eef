"""Parameter-holding layers shared by the models, channel-last.

Each keeps the parameter names and shapes of its torch counterpart in the
reference state dict (nn.Conv2d OIHW weights, norm `weight`/`bias`), while
taking and returning channel-last activations as the JAX package does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import Optional, Tuple

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.conv2d import (CENSUS, conv3x3_eligible,
                                               conv3x3_fused,
                                               conv3x3_fused_eligible,
                                               conv3x3_ninedot, conv3x3_nhwc)
from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
from open_pandora_tpu_torch.ops.norms import group_norm, layer_norm


class Conv2d(nn.Conv2d):
    """nn.Conv2d over (N, H, W, C). The permutes are views: the convolution
    sees a channels-last NCHW tensor and returns one."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SConv3x3(Conv2d):
    """Stride-1 same-pad 3x3 conv with the JAX package's opt-in conv routes
    (`_SConv3x3`, open_pandora_tpu/models/unet3d.py:502-558). It keeps
    nn.Conv2d's OIHW `weight` and `bias`, so the state-dict keys do not
    change. `fast` (eval only: the kernels are forward-only) with
    `kernels.fused_available(x)`, branch for branch as in JAX:
      - the fused conv kernel where `conv3x3_fused_eligible` admits the
        site, with the caller's prologue (a, s) and residual;
      - else the prologue un-fused in plain code, then the direct conv
        kernel where `conv3x3_eligible` admits it, the residual added
        outside in x.dtype;
      - else, under PANDORA_SPATIAL_DOT, nine shifted matmuls;
      - else the library convolution.
    The weight in the kernel's (Co, 9 C) layout is derived once per dtype
    and device and kept until the parameter changes (its version
    counter)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)
        self._packed = None

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight
        key = (w._version, w.data_ptr(), w.device, dtype)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                packed = w.detach().permute(0, 2, 3, 1).reshape(
                    w.shape[0], -1).to(dtype).contiguous()
            self._packed = (key, packed)
        return self._packed[1]

    def forward(self, x: torch.Tensor, fast: bool = False,
                prologue: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        h, w, c = x.shape[1], x.shape[2], x.shape[3]
        co = self.out_channels
        if flags.flag("PANDORA_CONV_CENSUS"):
            CENSUS.add((h, w, c, co))
        w_hwio = self.weight.permute(2, 3, 1, 0)       # a view, JAX's HWIO
        kernel_ok = fast and kernels.fused_available(x)
        if kernel_ok and conv3x3_fused_eligible(h, w, c, co):
            a, s = prologue if prologue is not None else (None, None)
            return conv3x3_fused(x, w_hwio, self.bias, a, s, residual,
                                 packed=self.packed_weight(x.dtype))
        if prologue is not None:                        # un-fuse: affine+silu
            a, s = prologue
            x = F.silu(x.float() * a[:, None, None, :]
                       + s[:, None, None, :]).to(x.dtype)
        if kernel_ok and conv3x3_eligible(h, w, c, co):
            y = conv3x3_nhwc(x, w_hwio, self.bias,
                             packed=self.packed_weight(x.dtype))
        elif flags.flag("PANDORA_SPATIAL_DOT"):
            y = conv3x3_ninedot(x, w_hwio, self.bias)
        else:
            y = super().forward(x)
        return y if residual is None else y + residual.to(y.dtype)


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

    def fold(self, x: torch.Tensor, extra: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The per-(batch, channel) affine fold for the fused conv kernel
        (JAX `GroupNorm32(stats_only=True)`, models/unet3d.py:65-90):
        GN(x + extra) == x * a + b with a = gamma / sigma_g and
        b = (e - mu_g) * a + beta. The group statistics of x + e come from
        per-channel fp32 moments of x in one pass, var = E[v^2] - mu^2, as
        in JAX (not the two-pass statistics of the GroupNorm kernel).
        x (B, ..., C), extra (B, C) or None; a, b (B, C) fp32."""
        c = x.shape[-1]
        xf = x.float()
        red = tuple(range(1, x.ndim - 1))
        m1 = xf.mean(dim=red)
        m2 = xf.square().mean(dim=red)
        e = torch.zeros_like(m1) if extra is None else extra.float()
        gshape = (m1.shape[0], 32, c // 32)
        mu = (m1 + e).reshape(gshape).mean(dim=-1)
        ex2 = (m2 + 2 * e * m1 + e.square()).reshape(gshape).mean(dim=-1)
        inv = torch.rsqrt(ex2 - mu.square() + self.eps)
        mu = mu.repeat_interleave(c // 32, dim=-1)
        inv = inv.repeat_interleave(c // 32, dim=-1)
        a = self.weight.float() * inv
        return a, (e - mu) * a + self.bias.float()


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
