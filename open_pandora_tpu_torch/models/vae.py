"""SD 2D autoencoder (AutoencoderKL), channel-last.

Counterpart of open_pandora_tpu/models/vae.py. Module and parameter names
follow the reference state dict (`encoder.down.0.block.1.norm1.weight`,
`decoder.mid.attn_1.q.weight`, ...). GroupNorm eps is 1e-6 throughout; in
bf16 eval on a CUDA device every GroupNorm takes the GroupNorm+SiLU kernel.
The mid-block attention is one head of width C through the attention
dispatcher (the flash kernel at h*w >= 512 on a CUDA device; its width
fails the packed kernel's head gate, as in the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import VAEConfig
from open_pandora_tpu_torch.models.layers import (Conv2d, GroupNorm32,
                                                  PointwiseConv, nearest_up2)
from open_pandora_tpu_torch.ops.attention import attention

EPS = 1e-6


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, EPS)
        self.conv1 = Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm32(out_ch, EPS)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = (PointwiseConv(in_ch, out_ch)
                             if in_ch != out_ch else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 eval on a CUDA device: the GroupNorm+SiLU kernel
        h = self.conv1(self.norm1(x, silu=True))
        h = self.conv2(self.norm2(h, silu=True))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head self-attention over h*w tokens, D = C."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm32(ch, EPS)
        self.q = PointwiseConv(ch, ch)
        self.k = PointwiseConv(ch, ch)
        self.v = PointwiseConv(ch, ch)
        self.proj_out = PointwiseConv(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q = self.q(h).reshape(b, hh * ww, 1, c)
        k = self.k(h).reshape(b, hh * ww, 1, c)
        v = self.v(h).reshape(b, hh * ww, 1, c)
        out = attention(q, k, v).reshape(b, hh, ww, c)
        return x + self.proj_out(out)


class Downsample(nn.Module):
    """Stride-2 3x3 conv after an asymmetric (0, 1, 0, 1) pad."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_up2(x))


class _Level(nn.Module):
    def __init__(self, blocks, resample: Optional[nn.Module], name: str):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample is not None:
            self.add_module(name, resample)


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        base = cfg.base_channels
        self.conv_in = Conv2d(cfg.in_channels, base, 3, padding=1)
        levels, ch = [], base
        for i, mult in enumerate(cfg.channel_mult):
            out_ch = base * mult
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, out_ch))
                ch = out_ch
            last = i == len(cfg.channel_mult) - 1
            levels.append(_Level(blocks, None if last else Downsample(ch),
                                 "downsample"))
        self.down = nn.ModuleList(levels)
        self.mid = _Mid(ch)
        self.norm_out = GroupNorm32(ch, EPS)
        z_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.conv_out = Conv2d(ch, z_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid(h)
        return self.conv_out(self.norm_out(h, silu=True))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        base = cfg.base_channels
        ch = base * cfg.channel_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, padding=1)
        self.mid = _Mid(ch)
        levels = [None] * len(cfg.channel_mult)
        for i in reversed(range(len(cfg.channel_mult))):
            out_ch = base * cfg.channel_mult[i]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, out_ch))
                ch = out_ch
            levels[i] = _Level(blocks, Upsample(ch) if i != 0 else None,
                               "upsample")
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm32(ch, EPS)
        self.conv_out = Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, silu=True))


@dataclass
class DiagonalGaussian:
    """Posterior over latents; logvar clamped to [-30, 20]."""

    mean: torch.Tensor
    logvar: torch.Tensor

    @classmethod
    def from_params(cls, moments: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = moments.chunk(2, dim=-1)
        return cls(mean=mean, logvar=logvar.clamp(-30.0, 20.0))

    def mode(self) -> torch.Tensor:
        return self.mean

    def sample(self, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """mean + std * eps, eps ~ N(0, 1) of the mean's shape and dtype,
        drawn from `generator` unless given."""
        if eps is None:
            eps = torch.randn(self.mean.shape, generator=generator,
                              device=self.mean.device, dtype=self.mean.dtype)
        std = torch.exp(0.5 * self.logvar)
        return self.mean + std * eps.to(self.mean.device, self.mean.dtype)


class AutoencoderKL(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        z_in = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        self.quant_conv = PointwiseConv(
            z_in, 2 * cfg.embed_dim if cfg.double_z else cfg.embed_dim)
        self.post_quant_conv = PointwiseConv(cfg.embed_dim, cfg.z_channels)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return DiagonalGaussian.from_params(self.quant_conv(self.encoder(x)))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z))


def _frame_chunks(t: int, frame_chunk: int):
    fc = frame_chunk if t % frame_chunk == 0 else 1
    return [(s, s + fc) for s in range(0, t, fc)]


def encode_video(vae: AutoencoderKL, video: torch.Tensor, *,
                 scale_factor: float = 0.18215, frame_chunk: int = 1,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """video (b, t, h, w, c) -> latents (b, t, h/8, w/8, z) * scale, encoded
    `frame_chunk` frames at a time. The posterior's mode (deterministic
    conditioning, the JAX package's default) unless a generator or the
    noise `eps` is given: then one sample of the whole posterior, as the
    reference's training does (ddpm3d.py:595-602)."""
    b, t, h, w, c = video.shape
    moments = []
    for s, e in _frame_chunks(t, frame_chunk):
        x = vae.quant_conv(vae.encoder(
            video[:, s:e].reshape(b * (e - s), h, w, c)))
        moments.append(x.reshape(b, e - s, *x.shape[1:]))
    post = DiagonalGaussian.from_params(torch.cat(moments, dim=1))
    if generator is None and eps is None:
        return post.mode() * scale_factor
    return post.sample(generator, eps) * scale_factor


def decode_video(vae: AutoencoderKL, z: torch.Tensor, *,
                 scale_factor: float = 0.18215,
                 frame_chunk: int = 1) -> torch.Tensor:
    """latents (b, t, h', w', z) -> video (b, t, 8h', 8w', 3), decoded
    `frame_chunk` frames at a time."""
    b, t, h, w, zc = z.shape
    z = z / scale_factor
    out = []
    for s, e in _frame_chunks(t, frame_chunk):
        frames = vae.decode(z[:, s:e].reshape(b * (e - s), h, w, zc))
        out.append(frames.reshape(b, e - s, *frames.shape[1:]))
    return torch.cat(out, dim=1)
