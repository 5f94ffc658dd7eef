"""Plain PyTorch reference of DynamiCrafter image-to-video: the UNet3D, the
SD autoencoder, the OpenCLIP ViT-H text and image towers and the Perceiver
Resampler, channel-last, with the parameter names of the reference state
dict (`model.diffusion_model.input_blocks.1.0.in_layers.0.weight`, ...).

A frozen copy of the model math the benchmark holds the program to: every
product is a plain matmul, einsum or convolution, every norm a plain fp32
GroupNorm or LayerNorm, attention an explicit softmax(q k^T) v in blocks of
heads so that the 9216-token scores of 576x1024 fit. No kernel, no route,
no dropout (eval), no checkpointing. It imports nothing of the program.

`Numerics` says how it computes: in the parameters' dtype (float32 for the
reference, with TF32 off; see `fp32_exact`), or, for the control, with the
operands of every product (weights and activations) rounded to fp8 e4m3
with one scale per tensor, the precision below the bf16 the configuration
states.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0
NEG_INF = -0.7 * torch.finfo(torch.float32).max


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under one per-tensor scale (amax to 448),
    returned in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / FP8_MAX
    q = (t.float() / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)
    return (q.float() * scale).to(t.dtype)


class Numerics:
    """fp8=False: plain arithmetic in the tensors' dtype. fp8=True (the
    control): every product's operands are rounded to fp8 first, and the
    sampler's carried latent too."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t) if self.fp8 else t

    def linear(self, x, weight, bias=None):
        return F.linear(self.op(x), self.op(weight), bias)

    def conv(self, x, weight, bias, stride=1, padding=0):
        """Channel-last conv: x (N, H, W, C), weight OIHW."""
        y = F.conv2d(self.op(x).permute(0, 3, 1, 2), self.op(weight), bias,
                     stride=stride, padding=padding)
        return y.permute(0, 2, 3, 1)

    def attention(self, q, k, v, causal: bool = False,
                  max_scores: int = 2 ** 28):
        """q (B, N, H, D), k/v (B, M, H, D) -> (B, N, H, D); the scores of
        at most `max_scores` elements at a time."""
        b, n, h, d = q.shape
        m = k.shape[1]
        qh = self.op(q).permute(0, 2, 1, 3).reshape(b * h, n, d)
        kh = self.op(k).permute(0, 2, 1, 3).reshape(b * h, m, d)
        vh = self.op(v).permute(0, 2, 1, 3).reshape(b * h, m, d)
        out = torch.empty_like(qh)
        rows = max(1, max_scores // (n * m))
        for s in range(0, b * h, rows):
            sc = torch.bmm(qh[s:s + rows], kh[s:s + rows].transpose(1, 2))
            sc = sc * d ** -0.5
            if causal:
                keep = (torch.arange(m, device=q.device)[None]
                        <= torch.arange(n, device=q.device)[:, None]
                        + (m - n))
                sc = torch.where(keep, sc, NEG_INF)
            p = torch.softmax(sc, dim=-1)
            out[s:s + rows] = torch.bmm(self.op(p), vh[s:s + rows])
        return out.reshape(b, h, n, d).permute(0, 2, 1, 3)


@contextlib.contextmanager
def fp32_exact():
    """float32 products without TF32, restored on exit."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Linear(nn.Module):
    def __init__(self, nm: Numerics, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.nm = nm
        self.weight = _p(dout, din)
        self.bias = _p(dout) if bias else None

    def forward(self, x):
        return self.nm.linear(x, self.weight, self.bias)


class Pointwise(nn.Module):
    """Kernel-size-1 conv (weight (out, in, 1[, 1])) over the channel axis."""

    def __init__(self, nm: Numerics, din: int, dout: int, dims: int = 2):
        super().__init__()
        self.nm = nm
        self.weight = _p(dout, din, *([1] * dims))
        self.bias = _p(dout)

    def forward(self, x):
        return self.nm.linear(x, self.weight.reshape(self.weight.shape[:2]),
                              self.bias)


class Conv(nn.Module):
    def __init__(self, nm: Numerics, din: int, dout: int, k: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__()
        self.nm, self.stride, self.padding = nm, stride, padding
        self.weight = _p(dout, din, k, k)
        self.bias = _p(dout) if bias else None

    def forward(self, x):
        return self.nm.conv(x, self.weight, self.bias, self.stride,
                            self.padding)


class GroupNorm(nn.Module):
    """GroupNorm(32), fp32 statistics, channel-last; optional SiLU."""

    def __init__(self, ch: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = _p(ch)
        self.bias = _p(ch)

    def forward(self, x, silu: bool = False):
        c = x.shape[-1]
        xf = x.float().reshape(x.shape[0], -1, 32, c // 32)
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True,
                                   correction=0)
        y = ((xf - mean) / torch.sqrt(var + self.eps)).reshape(x.shape)
        y = y * self.weight.float() + self.bias.float()
        return (F.silu(y) if silu else y).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = _p(dim)
        self.bias = _p(dim)

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


def _list(*mods) -> nn.ModuleList:
    return nn.ModuleList(mods)


# -- UNet3D -------------------------------------------------------------------

def bf16_freq_table(half: int, max_period: int = 10000) -> torch.Tensor:
    """The timestep embedding's frequencies as the reference model computes
    them: each step rounded to bf16."""
    bf16 = torch.bfloat16
    i = torch.arange(half, dtype=torch.float64)
    a = (-math.log(max_period) * i).to(bf16)
    a = (a.double() / half).to(bf16)
    return torch.exp(a.float()).to(bf16).float()


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    args = t.float()[:, None] * bf16_freq_table(half).to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class CrossAttention(nn.Module):
    def __init__(self, nm, dim, heads, dim_head, ctx_dim=None,
                 image_cross=False, text_len=77):
        super().__init__()
        inner, ctx_dim = heads * dim_head, ctx_dim or dim
        self.nm, self.heads, self.dh = nm, heads, dim_head
        self.image_cross, self.text_len = image_cross, text_len
        self.to_q = Linear(nm, dim, inner, bias=False)
        self.to_k = Linear(nm, ctx_dim, inner, bias=False)
        self.to_v = Linear(nm, ctx_dim, inner, bias=False)
        self.to_out = _list(Linear(nm, inner, dim))
        if image_cross:
            self.to_k_ip = Linear(nm, ctx_dim, inner, bias=False)
            self.to_v_ip = Linear(nm, ctx_dim, inner, bias=False)

    def _h(self, t):
        return t.reshape(t.shape[0], t.shape[1], self.heads, self.dh)

    def forward(self, x, context=None):
        b, n, _ = x.shape
        q = self._h(self.to_q(x))
        if self.image_cross and context is not None:
            txt, img = context[:, :self.text_len], context[:, self.text_len:]
            out = self.nm.attention(q, self._h(self.to_k(txt)),
                                    self._h(self.to_v(txt)))
            out = out + self.nm.attention(q, self._h(self.to_k_ip(img)),
                                          self._h(self.to_v_ip(img)))
        else:
            ctx = x if context is None else context[:, :self.text_len]
            out = self.nm.attention(q, self._h(self.to_k(ctx)),
                                    self._h(self.to_v(ctx)))
        return self.to_out[0](out.reshape(b, n, -1))


class GEGLU(nn.Module):
    def __init__(self, nm, din, dout):
        super().__init__()
        self.proj = Linear(nm, din, dout * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, nm, dim, mult=4, max_rows=2 ** 16):
        super().__init__()
        self.max_rows = max_rows
        self.net = nn.ModuleDict({"0": GEGLU(nm, dim, dim * mult),
                                  "2": Linear(nm, dim * mult, dim)})

    def forward(self, x):
        flat = x.reshape(-1, x.shape[-1])
        step = self.max_rows
        out = torch.cat([self.net["2"](self.net["0"](flat[s:s + step]))
                         for s in range(0, flat.shape[0], step)])
        return out.reshape(x.shape)


class TransformerBlock(nn.Module):
    def __init__(self, nm, dim, heads, dh, ctx_dim=None, image_cross=False,
                 text_len=77):
        super().__init__()
        self.attn1 = CrossAttention(nm, dim, heads, dh)
        self.attn2 = CrossAttention(nm, dim, heads, dh, ctx_dim, image_cross,
                                    text_len)
        self.ff = FeedForward(nm, dim)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim), LayerNorm(dim),
                                              LayerNorm(dim))

    def forward(self, x, context=None):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, nm, ch, heads, dh, depth, ctx_dim, text_len):
        super().__init__()
        inner = heads * dh
        self.norm = GroupNorm(ch, 1e-6)
        self.proj_in = Linear(nm, ch, inner)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(nm, inner, heads, dh, ctx_dim, True, text_len)
            for _ in range(depth))
        self.proj_out = Linear(nm, inner, ch)

    def forward(self, x, context):
        bt, h, w, c = x.shape
        y = self.proj_in(self.norm(x).reshape(bt, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + self.proj_out(y).reshape(bt, h, w, c)


class TemporalTransformer(nn.Module):
    """Self-attention over t at every spatial position of (b, t, h, w, c)."""

    def __init__(self, nm, ch, heads, dh, depth, use_linear=True):
        super().__init__()
        inner = heads * dh
        self.norm = GroupNorm(ch, 1e-6)
        if use_linear:
            self.proj_in = Linear(nm, ch, inner)
            self.proj_out = Linear(nm, inner, ch)
        else:
            self.proj_in = Pointwise(nm, ch, inner, dims=1)
            self.proj_out = Pointwise(nm, inner, ch, dims=1)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(nm, inner, heads, dh) for _ in range(depth))

    def forward(self, x):
        b, t, h, w, c = x.shape
        y = self.norm(x).permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        y = self.proj_in(y)
        for blk in self.transformer_blocks:
            y = blk(y)
        y = self.proj_out(y).reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)
        return x + y


class TConv3(nn.Module):
    """Conv3d with kernel (3, 1, 1), padding (1, 0, 0) over the t axis."""

    def __init__(self, nm, ch):
        super().__init__()
        self.nm = nm
        self.weight = _p(ch, ch, 3, 1, 1)
        self.bias = _p(ch)

    def forward(self, x):
        t = x.shape[1]
        w = self.weight[:, :, :, 0, 0]
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        return sum(self.nm.linear(xp[:, i:i + t], w[..., i])
                   for i in range(3)) + self.bias


class TemporalConvBlock(nn.Module):
    def __init__(self, nm, ch):
        super().__init__()
        self.conv1 = nn.ModuleDict({"0": GroupNorm(ch, 1e-5),
                                    "2": TConv3(nm, ch)})
        for i in (2, 3, 4):
            self.add_module(f"conv{i}", nn.ModuleDict(
                {"0": GroupNorm(ch, 1e-5), "3": TConv3(nm, ch)}))

    def forward(self, x):
        h = self.conv1["2"](self.conv1["0"](x, silu=True))
        for layer in (self.conv2, self.conv3, self.conv4):
            h = layer["3"](layer["0"](h, silu=True))
        return x + h


class ResBlock(nn.Module):
    def __init__(self, nm, cin, cout, emb_dim, temporal_conv):
        super().__init__()
        self.in_layers = nn.ModuleDict({"0": GroupNorm(cin, 1e-5),
                                        "2": Conv(nm, cin, cout, 3,
                                                  padding=1)})
        self.emb_layers = nn.ModuleDict({"1": Linear(nm, emb_dim, cout)})
        self.out_layers = nn.ModuleDict({"0": GroupNorm(cout, 1e-5),
                                         "3": Conv(nm, cout, cout, 3,
                                                   padding=1)})
        self.skip_connection = (Pointwise(nm, cin, cout) if cin != cout
                                else None)
        self.temopral_conv = (TemporalConvBlock(nm, cout) if temporal_conv
                              else None)

    def forward(self, x, emb, b):
        h = self.in_layers["2"](self.in_layers["0"](x, silu=True))
        h = h + self.emb_layers["1"](F.silu(emb))[:, None, None, :]
        h = self.out_layers["3"](self.out_layers["0"](h, silu=True))
        skip = x if self.skip_connection is None else self.skip_connection(x)
        h = skip + h
        if self.temopral_conv is not None:
            bt, hh, ww, c = h.shape
            h = self.temopral_conv(h.reshape(b, bt // b, hh, ww, c)
                                   ).reshape(bt, hh, ww, c)
        return h


class Downsample(nn.Module):
    def __init__(self, nm, ch):
        super().__init__()
        self.op = Conv(nm, ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


def nearest_up2(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class Upsample(nn.Module):
    def __init__(self, nm, ch):
        super().__init__()
        self.conv = Conv(nm, ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(nearest_up2(x))


class UNet(nn.Module):
    """x (b, t, h, w, c_in), t (b,), context (b, L, ctx), fs (b,) ->
    (b, t, h, w, out_channels)."""

    def __init__(self, nm: Numerics, cfg: SimpleNamespace):
        super().__init__()
        self.cfg = cfg
        mc, hc = cfg.model_channels, cfg.num_head_channels
        ted = mc * 4
        self.time_embed = nn.ModuleDict({"0": Linear(nm, mc, ted),
                                         "2": Linear(nm, ted, ted)})
        self.fps_embedding = nn.ModuleDict({"0": Linear(nm, mc, ted),
                                            "2": Linear(nm, ted, ted)})
        depth = cfg.transformer_depth

        def res(cin, cout):
            return ResBlock(nm, cin, cout, ted, True)

        def spatial(ch):
            return SpatialTransformer(nm, ch, ch // hc, hc, depth,
                                      cfg.context_dim, cfg.text_context_len)

        def temporal(ch, heads=None, use_linear=True):
            return TemporalTransformer(nm, ch, heads or ch // hc, hc, depth,
                                       use_linear)

        self.init_attn = _list(temporal(mc, heads=8, use_linear=False))
        inputs = [_list(Conv(nm, cfg.in_channels, mc, 3, padding=1))]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                block = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block += [spatial(ch), temporal(ch)]
                inputs.append(_list(*block))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                inputs.append(_list(Downsample(nm, ch)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(inputs)
        self.middle_block = _list(res(ch, ch), spatial(ch), temporal(ch),
                                  res(ch, ch))
        outputs = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                block = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block += [spatial(ch), temporal(ch)]
                if level and i == cfg.num_res_blocks:
                    block.append(Upsample(nm, ch))
                    ds //= 2
                outputs.append(_list(*block))
        self.output_blocks = nn.ModuleList(outputs)
        self.out = nn.ModuleDict({"0": GroupNorm(ch, 1e-5),
                                  "2": Conv(nm, ch, cfg.out_channels, 3,
                                            padding=1)})

    def _embed(self, layers, steps, dtype):
        e = timestep_embedding(steps, self.cfg.model_channels).to(dtype)
        return layers["2"](F.silu(layers["0"](e)))

    def _run(self, block, h, emb, ctx, b):
        for layer in block:
            if isinstance(layer, ResBlock):
                h = layer(h, emb, b)
            elif isinstance(layer, SpatialTransformer):
                h = layer(h, ctx)
            elif isinstance(layer, TemporalTransformer):
                bt, sh, sw, c = h.shape
                h = layer(h.reshape(b, bt // b, sh, sw, c)).reshape(h.shape)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context, fs):
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        dtype = self.out["2"].weight.dtype
        emb = (self._embed(self.time_embed, timesteps, dtype)
               + self._embed(self.fps_embedding, fs, dtype))
        n_img = cfg.img_tokens_per_frame
        ctx_text = context[:, :cfg.text_context_len].repeat_interleave(t, 0)
        ctx_img = context[:, cfg.text_context_len:].reshape(b * t, n_img, -1)
        ctx = torch.cat([ctx_text, ctx_img], dim=1).to(dtype)
        emb = emb.repeat_interleave(t, dim=0)
        h = self.input_blocks[0][0](x.reshape(b * t, hh, ww, -1).to(dtype))
        h = self._run(self.init_attn, h, emb, ctx, b)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, emb, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, b)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx,
                          b)
        y = self.out["2"](self.out["0"](h, silu=True))
        return y.reshape(b, t, hh, ww, cfg.out_channels)


# -- VAE ----------------------------------------------------------------------

class VResBlock(nn.Module):
    def __init__(self, nm, cin, cout):
        super().__init__()
        self.norm1 = GroupNorm(cin, 1e-6)
        self.conv1 = Conv(nm, cin, cout, 3, padding=1)
        self.norm2 = GroupNorm(cout, 1e-6)
        self.conv2 = Conv(nm, cout, cout, 3, padding=1)
        self.nin_shortcut = Pointwise(nm, cin, cout) if cin != cout else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x, True)), True))
        return (x if self.nin_shortcut is None else self.nin_shortcut(x)) + h


class VAttn(nn.Module):
    def __init__(self, nm, ch):
        super().__init__()
        self.nm = nm
        self.norm = GroupNorm(ch, 1e-6)
        self.q, self.k, self.v, self.proj_out = (Pointwise(nm, ch, ch)
                                                 for _ in range(4))

    def forward(self, x):
        b, hh, ww, c = x.shape
        h = self.norm(x)
        q, k, v = (f(h).reshape(b, hh * ww, 1, c)
                   for f in (self.q, self.k, self.v))
        out = self.nm.attention(q, k, v).reshape(b, hh, ww, c)
        return x + self.proj_out(out)


class VMid(nn.Module):
    def __init__(self, nm, ch):
        super().__init__()
        self.block_1 = VResBlock(nm, ch, ch)
        self.attn_1 = VAttn(nm, ch)
        self.block_2 = VResBlock(nm, ch, ch)

    def forward(self, x):
        return self.block_2(self.attn_1(self.block_1(x)))


class VLevel(nn.Module):
    def __init__(self, blocks, name=None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        self.resample_name = name if resample is not None else None
        if resample is not None:
            self.add_module(name, resample)


class VDown(nn.Module):
    """Stride-2 3x3 conv after a (0, 1, 0, 1) pad."""

    def __init__(self, nm, ch):
        super().__init__()
        self.conv = Conv(nm, ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 0, 0, 1, 0, 1)))


class Encoder(nn.Module):
    def __init__(self, nm, cfg):
        super().__init__()
        base = cfg.base_channels
        self.conv_in = Conv(nm, cfg.in_channels, base, 3, padding=1)
        levels, ch = [], base
        for i, mult in enumerate(cfg.channel_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(VResBlock(nm, ch, base * mult))
                ch = base * mult
            last = i == len(cfg.channel_mult) - 1
            levels.append(VLevel(blocks, "downsample",
                                 None if last else VDown(nm, ch)))
        self.down = nn.ModuleList(levels)
        self.mid = VMid(nm, ch)
        self.norm_out = GroupNorm(ch, 1e-6)
        self.conv_out = Conv(nm, ch, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if level.resample_name:
                h = level.downsample(h)
        return self.conv_out(self.norm_out(self.mid(h), True))


class Decoder(nn.Module):
    def __init__(self, nm, cfg):
        super().__init__()
        base = cfg.base_channels
        ch = base * cfg.channel_mult[-1]
        self.conv_in = Conv(nm, cfg.z_channels, ch, 3, padding=1)
        self.mid = VMid(nm, ch)
        levels = [None] * len(cfg.channel_mult)
        for i in reversed(range(len(cfg.channel_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VResBlock(nm, ch, base * cfg.channel_mult[i]))
                ch = base * cfg.channel_mult[i]
            up = None
            if i != 0:
                up = Upsample(nm, ch)
            levels[i] = VLevel(blocks, "upsample", up)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(ch, 1e-6)
        self.conv_out = Conv(nm, ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid(self.conv_in(z))
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h)
            if level.resample_name:
                h = level.upsample(h)
        return self.conv_out(self.norm_out(h, True))


class AutoencoderKL(nn.Module):
    def __init__(self, nm, cfg):
        super().__init__()
        self.encoder = Encoder(nm, cfg)
        self.decoder = Decoder(nm, cfg)
        self.quant_conv = Pointwise(nm, 2 * cfg.z_channels,
                                    2 * cfg.embed_dim)
        self.post_quant_conv = Pointwise(nm, cfg.embed_dim, cfg.z_channels)


# -- OpenCLIP towers and the Resampler ----------------------------------------

class MHA(nn.Module):
    def __init__(self, nm, d):
        super().__init__()
        self.in_proj_weight = _p(3 * d, d)
        self.in_proj_bias = _p(3 * d)
        self.out_proj = Linear(nm, d, d)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, nm, d, heads):
        super().__init__()
        self.nm, self.heads = nm, heads
        self.ln_1, self.ln_2 = LayerNorm(d), LayerNorm(d)
        self.attn = MHA(nm, d)
        self.mlp = nn.ModuleDict({"c_fc": Linear(nm, d, 4 * d),
                                  "c_proj": Linear(nm, 4 * d, d)})

    def forward(self, x, causal=False):
        b, n, d = x.shape
        qkv = self.nm.linear(self.ln_1(x), self.attn.in_proj_weight,
                             self.attn.in_proj_bias)
        q, k, v = (t.reshape(b, n, self.heads, d // self.heads)
                   for t in qkv.chunk(3, dim=-1))
        o = self.nm.attention(q, k, v, causal=causal).reshape(b, n, d)
        x = x + self.attn.out_proj(o)
        return x + self.mlp["c_proj"](F.gelu(self.mlp["c_fc"](self.ln_2(x))))


class TextEncoder(nn.Module):
    """OpenCLIP text tower to the penultimate layer."""

    def __init__(self, nm, cfg):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.token_embedding.weight.requires_grad_(False)
        self.positional_embedding = _p(cfg.context_length, cfg.width)
        blocks = cfg.layers - (1 if cfg.penultimate else 0)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(nm, cfg.width, cfg.heads)
            for _ in range(blocks))
        self.ln_final = LayerNorm(cfg.width)

    def forward(self, ids):
        x = self.token_embedding(ids) + self.positional_embedding
        for blk in self.transformer.resblocks:
            x = blk(x, causal=True)
        return self.ln_final(x)


class VisionEncoder(nn.Module):
    """OpenCLIP ViT: (b, 224, 224, 3) normalised -> (b, 257, width)."""

    def __init__(self, nm, cfg):
        super().__init__()
        self.width = cfg.width
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Conv(nm, 3, cfg.width, cfg.patch_size,
                          stride=cfg.patch_size, bias=False)
        self.class_embedding = _p(cfg.width)
        self.positional_embedding = _p(grid * grid + 1, cfg.width)
        self.ln_pre = LayerNorm(cfg.width)
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            ResidualAttentionBlock(nm, cfg.width, cfg.heads)
            for _ in range(cfg.layers))

    def forward(self, images):
        b = images.shape[0]
        x = self.conv1(images).reshape(b, -1, self.width)
        x = torch.cat([self.class_embedding.expand(b, 1, -1), x], dim=1)
        x = self.ln_pre(x + self.positional_embedding)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x


class PerceiverAttention(nn.Module):
    def __init__(self, nm, dim, dh, heads):
        super().__init__()
        self.nm, self.heads, self.dh = nm, heads, dh
        inner = heads * dh
        self.norm1, self.norm2 = LayerNorm(dim), LayerNorm(dim)
        self.to_q = Linear(nm, dim, inner, bias=False)
        self.to_kv = Linear(nm, dim, 2 * inner, bias=False)
        self.to_out = Linear(nm, inner, dim, bias=False)

    def forward(self, x, lat):
        x, lat = self.norm1(x), self.norm2(lat)
        b, n, _ = lat.shape
        q = self.to_q(lat).reshape(b, n, self.heads, self.dh)
        kv_in = torch.cat([x, lat], dim=1)
        k, v = self.to_kv(kv_in).chunk(2, dim=-1)
        m = kv_in.shape[1]
        out = self.nm.attention(q, k.reshape(b, m, self.heads, self.dh),
                                v.reshape(b, m, self.heads, self.dh))
        return self.to_out(out.reshape(b, n, -1))


class Resampler(nn.Module):
    def __init__(self, nm, cfg):
        super().__init__()
        self.latents = _p(1, cfg.num_queries * cfg.video_length, cfg.dim)
        self.proj_in = Linear(nm, cfg.embedding_dim, cfg.dim)
        self.proj_out = Linear(nm, cfg.dim, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([
                PerceiverAttention(nm, cfg.dim, cfg.dim_head, cfg.heads),
                nn.ModuleDict({"0": LayerNorm(cfg.dim),
                               "1": Linear(nm, cfg.dim,
                                           cfg.dim * cfg.ff_mult, False),
                               "3": Linear(nm, cfg.dim * cfg.ff_mult,
                                           cfg.dim, False)})])
            for _ in range(cfg.depth))

    def forward(self, x):
        lat = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff["3"](F.gelu(ff["1"](ff["0"](lat))))
        return self.norm_out(self.proj_out(lat))


# -- the composite ------------------------------------------------------------

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def _ns(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})


class DynamiCrafter(nn.Module):
    """Submodules under the reference state-dict prefixes."""

    def __init__(self, config: dict, nm: Optional[Numerics] = None):
        super().__init__()
        nm = nm or Numerics()
        self.nm = nm
        self.cfg = {k: _ns(v) for k, v in config.items()
                    if isinstance(v, dict)}
        c = self.cfg
        self.model = nn.Module()
        self.model.diffusion_model = UNet(nm, c["unet"])
        self.first_stage_model = AutoencoderKL(nm, c["vae"])
        self.cond_stage_model = nn.Module()
        self.cond_stage_model.model = TextEncoder(nm, c["clip_text"])
        self.embedder = nn.Module()
        self.embedder.model = nn.Module()
        self.embedder.model.visual = VisionEncoder(nm, c["clip_vision"])
        self.image_proj_model = Resampler(nm, c["resampler"])

    @property
    def device(self):
        return self.image_proj_model.latents.device

    @property
    def dtype(self):
        return self.image_proj_model.latents.dtype

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        return self.cond_stage_model.model(ids.to(self.device))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images (b, h, w, 3) in [0, 1] -> (b, 256, 1024) image tokens."""
        size = self.cfg["clip_vision"].image_size
        x = F.interpolate(images.float().permute(0, 3, 1, 2),
                          size=(size, size), mode="bilinear",
                          align_corners=False, antialias=True)
        x = x.permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_MEAN, device=x.device)
        std = torch.tensor(CLIP_STD, device=x.device)
        x = ((x - mean) / std).to(self.dtype)
        return self.image_proj_model(self.embedder.model.visual(x))

    def encode_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """frame (b, h, w, 3) in [-1, 1] -> (b, T, h/8, w/8, 4): the VAE
        posterior's mode, scaled, repeated over the clip's frames."""
        vae = self.first_stage_model
        mom = vae.quant_conv(vae.encoder(frame.to(self.dtype)))
        z = mom.chunk(2, dim=-1)[0] * self.cfg["vae"].scale_factor
        t = self.cfg["unet"].temporal_length
        return z[:, None].repeat(1, t, 1, 1, 1)

    def eps(self, x, t, ctx, z_cond, fs):
        """The UNet on [x | z_cond] along channels."""
        x_in = torch.cat([x, z_cond], dim=-1).to(self.dtype)
        return self.model.diffusion_model(x_in, t, ctx.to(self.dtype), fs)

    def decode(self, z: torch.Tensor, frames: int = 1) -> torch.Tensor:
        """latents (b, T, h, w, 4) -> frames (b, T, 8h, 8w, 3), `frames` at
        a time."""
        vae = self.first_stage_model
        b, t = z.shape[:2]
        z = (z / self.cfg["vae"].scale_factor).to(self.dtype)
        out = []
        for s in range(0, t, frames):
            zz = z[:, s:s + frames].reshape(-1, *z.shape[2:])
            y = vae.decoder(vae.post_quant_conv(zz))
            out.append(y.reshape(b, -1, *y.shape[1:]))
        return torch.cat(out, dim=1)


def diffusion_frame(image: torch.Tensor, hw) -> torch.Tensor:
    """(H, W, 3) in [0, 1] -> (h, w, 3) in [-1, 1]: the shortest side to
    min(h, w) (bilinear, antialiased), scaled up if the box is not covered,
    centre crop."""
    h, w = hw

    def resize(x, size):
        y = F.interpolate(x.permute(2, 0, 1)[None], size=size,
                          mode="bilinear", align_corners=False,
                          antialias=True)
        return y[0].permute(1, 2, 0)

    x = image.float()
    H, W = x.shape[:2]
    side = min(h, w)
    x = resize(x, (round(H * side / W), side) if W < H
               else (side, round(W * side / H)))
    if x.shape[0] < h or x.shape[1] < w:
        s = max(h / x.shape[0], w / x.shape[1])
        x = resize(x, (round(x.shape[0] * s), round(x.shape[1] * s)))
    top, left = max((x.shape[0] - h) // 2, 0), max((x.shape[1] - w) // 2, 0)
    return x[top:top + h, left:left + w] * 2.0 - 1.0
