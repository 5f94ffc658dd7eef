"""Plain PyTorch reference of Stable Video Diffusion XT image-to-video,
for the CPU tests that hold the port (open_pandora_tpu_torch) to it: the
VideoUNet with its preconditioning, the conditioning (OpenCLIP ViT-H's
pooled embedding, the SD VAE encoder's concat latent, the vector), EDM's
sigmas, the linear guider and the Euler step, and the temporal
VideoDecoder, channel-last, with the parameter names of the released state
dict (`model.diffusion_model.input_blocks.1.0.time_stack.in_layers.2.weight`,
`conditioner.embedders.0.open_clip.model.visual.proj`, ...).

Written from Stability-AI generative-models (scripts/sampling/configs/
svd_xt.yaml; sgm/modules/diffusionmodules/video_model.py,
sgm/modules/video_attention.py, sgm/modules/autoencoding/temporal_ae.py,
sgm/modules/diffusionmodules/{denoiser_scaling,discretizer,sampling,
guiders}.py, sgm/modules/encoders/modules.py) as published: every frame
its own UNet batch row, every attention an explicit softmax over its keys
(the one-token cross-attentions too), every GroupNorm and LayerNorm plain
with float32 statistics, float32 throughout with TF32 off (`fp32_exact`).
It imports neither JAX nor the port; `benchmark/reference/svd.py` is the
benchmark's copy of the same model over its shared blocks.
"""

from __future__ import annotations

import contextlib
import math
from types import SimpleNamespace
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# -- plain blocks (as in the benchmark's DynamiCrafter reference) ----------


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


def _ns(d: dict) -> SimpleNamespace:
    return SimpleNamespace(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in d.items()})



# -- SVD-XT ----------------------------------------------------------------


def sinusoidal(t: torch.Tensor, dim: int, max_period: int = 10000
               ) -> torch.Tensor:
    """sgm's timestep_embedding: (n,) -> (n, dim) float32, [cos | sin]."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(0, half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def blend(mix_factor: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """alpha a + (1 - alpha) b, alpha = sigmoid(mix_factor)."""
    alpha = torch.sigmoid(mix_factor.float())
    return alpha.to(a.dtype) * a + (1.0 - alpha).to(a.dtype) * b


class TimeStack(nn.Module):
    """sgm's ResBlock at dims 3, kernel (3, 1, 1), over (b, t, h, w, c);
    its GroupNorms (eps 1e-5) over each video's frames and pixels."""

    def __init__(self, nm, ch, emb_dim=None):
        super().__init__()
        self.in_layers = nn.ModuleDict({"0": GroupNorm(ch, 1e-5),
                                        "2": TConv3(nm, ch)})
        if emb_dim is not None:
            self.emb_layers = nn.ModuleDict({"1": Linear(nm, emb_dim, ch)})
        self.out_layers = nn.ModuleDict({"0": GroupNorm(ch, 1e-5),
                                         "3": TConv3(nm, ch)})

    def forward(self, x, emb=None):
        h = self.in_layers["2"](self.in_layers["0"](x, silu=True))
        if emb is not None:
            h = h + self.emb_layers["1"](F.silu(emb))[:, :, None, None, :]
        return x + self.out_layers["3"](self.out_layers["0"](h, silu=True))


class Mixer(nn.Module):
    def __init__(self):
        super().__init__()
        self.mix_factor = _p(1)


class VideoResBlock(ResBlock):
    def __init__(self, nm, cin, cout, emb_dim):
        super().__init__(nm, cin, cout, emb_dim, False)
        self.time_stack = TimeStack(nm, cout, emb_dim)
        self.time_mixer = Mixer()

    def forward(self, x, emb, b):
        h = super().forward(x, emb, b)
        hv = h.reshape(b, h.shape[0] // b, *h.shape[1:])
        ht = self.time_stack(hv, emb.reshape(*hv.shape[:2], -1))
        return blend(self.time_mixer.mix_factor, hv, ht).reshape(h.shape)


class VideoBlock(nn.Module):
    """VideoTransformerBlock (ff_in, is_res) over (b s, t, c)."""

    def __init__(self, nm, dim, heads, dh, ctx_dim):
        super().__init__()
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(nm, dim)
        self.attn1 = CrossAttention(nm, dim, heads, dh)
        self.norm1 = LayerNorm(dim)
        self.attn2 = CrossAttention(nm, dim, heads, dh, ctx_dim, False, 1)
        self.norm2 = LayerNorm(dim)
        self.ff = FeedForward(nm, dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context):
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialVideoTransformer(nn.Module):
    def __init__(self, nm, ch, heads, dh, depth, ctx_dim):
        super().__init__()
        inner = heads * dh
        self.norm = GroupNorm(ch, 1e-6)
        self.proj_in = Linear(nm, ch, inner)
        self.transformer_blocks = nn.ModuleList(
            TransformerBlock(nm, inner, heads, dh, ctx_dim, False, 1)
            for _ in range(depth))
        self.proj_out = Linear(nm, inner, ch)
        self.time_stack = nn.ModuleList(
            VideoBlock(nm, inner, heads, dh, ctx_dim) for _ in range(depth))
        self.time_pos_embed = nn.ModuleDict({"0": Linear(nm, ch, 4 * ch),
                                             "2": Linear(nm, 4 * ch, ch)})
        self.time_mixer = Mixer()

    def forward(self, x, context, b):
        """x (b t, h, w, c), context (b t, 1, C)."""
        bt, h, w, c = x.shape
        t, s = bt // b, h * w
        y = self.proj_in(self.norm(x).reshape(bt, s, c))
        frames = torch.arange(t, device=x.device).repeat(b)
        pe = self.time_pos_embed
        emb = pe["2"](F.silu(pe["0"](sinusoidal(frames, c).to(y.dtype))
                             ))[:, None, :]
        time_ctx = context[::t].repeat_interleave(s, dim=0)
        for blk, mix in zip(self.transformer_blocks, self.time_stack):
            y = blk(y, context)
            d = y.shape[-1]
            ym = (y + emb).reshape(b, t, s, d).permute(0, 2, 1, 3)
            ym = mix(ym.reshape(b * s, t, d), time_ctx)
            ym = ym.reshape(b, s, t, d).permute(0, 2, 1, 3).reshape(bt, s, d)
            y = blend(self.time_mixer.mix_factor, y, ym)
        return x + self.proj_out(y).reshape(bt, h, w, c)


class VideoUNet(nn.Module):
    """x (b, t, h, w, c_in), c_noise (b,), context (b, 1, C), y (b, adm) ->
    (b, t, h, w, out_channels); as published, the frames are batch rows,
    each with its video's c_noise, context and vector."""

    def __init__(self, nm, cfg):
        super().__init__()
        self.cfg = cfg
        mc, hc = cfg.model_channels, cfg.num_head_channels
        ted = mc * 4
        self.time_embed = nn.ModuleDict({"0": Linear(nm, mc, ted),
                                         "2": Linear(nm, ted, ted)})
        self.label_emb = nn.ModuleDict({"0": nn.ModuleDict({
            "0": Linear(nm, cfg.adm_in_channels, ted),
            "2": Linear(nm, ted, ted)})})

        def attn(ch):
            return SpatialVideoTransformer(nm, ch, ch // hc, hc,
                                           cfg.transformer_depth,
                                           cfg.context_dim)

        inputs = [_list(Conv(nm, cfg.in_channels, mc, 3, padding=1))]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                block = [VideoResBlock(nm, ch, mult * mc, ted)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(attn(ch))
                inputs.append(_list(*block))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                inputs.append(_list(Downsample(nm, ch)))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(inputs)
        self.middle_block = _list(VideoResBlock(nm, ch, ch, ted), attn(ch),
                                  VideoResBlock(nm, ch, ch, ted))
        outputs = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                block = [VideoResBlock(nm, ch + chans.pop(), mult * mc, ted)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(attn(ch))
                if level and i == cfg.num_res_blocks:
                    block.append(Upsample(nm, ch))
                    ds //= 2
                outputs.append(_list(*block))
        self.output_blocks = nn.ModuleList(outputs)
        self.out = nn.ModuleDict({"0": GroupNorm(ch, 1e-5),
                                  "2": Conv(nm, ch, cfg.out_channels, 3,
                                            padding=1)})

    def _run(self, block, h, emb, ctx, b):
        for layer in block:
            if isinstance(layer, VideoResBlock):
                h = layer(h, emb, b)
            elif isinstance(layer, SpatialVideoTransformer):
                h = layer(h, ctx, b)
            else:
                h = layer(h)
        return h

    def forward(self, x, c_noise, context, y):
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        dtype = self.out["2"].weight.dtype
        te, le = self.time_embed, self.label_emb["0"]
        e = sinusoidal(c_noise.repeat_interleave(t), cfg.model_channels)
        emb = te["2"](F.silu(te["0"](e.to(dtype))))
        emb = emb + le["2"](F.silu(le["0"](y.repeat_interleave(t, 0)
                                           .to(dtype))))
        ctx = context.repeat_interleave(t, 0).to(dtype)
        h = self.input_blocks[0][0](x.reshape(b * t, hh, ww, -1).to(dtype))
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, emb, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, b)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx,
                          b)
        out = self.out["2"](self.out["0"](h, silu=True))
        return out.reshape(b, t, hh, ww, cfg.out_channels)


class VideoResnet(VResBlock):
    """The decoder's ResnetBlock and its time stack, alpha weighting the
    temporal branch."""

    def __init__(self, nm, cin, cout):
        super().__init__(nm, cin, cout)
        self.time_stack = TimeStack(nm, cout)
        self.mix_factor = _p(1)

    def forward(self, x, t):
        h = super().forward(x)
        hv = h.reshape(-1, t, *h.shape[1:])
        return blend(self.mix_factor, self.time_stack(hv), hv
                     ).reshape(h.shape)


class VideoDecoder(nn.Module):
    """sgm's VideoDecoder, time_mode conv-only: (n t, h, w, z) -> frames,
    each chunk of t frames one video."""

    def __init__(self, nm, cfg):
        super().__init__()
        base = cfg.base_channels
        ch = base * cfg.channel_mult[-1]
        self.conv_in = Conv(nm, cfg.z_channels, ch, 3, padding=1)
        self.mid = nn.Module()
        self.mid.block_1 = VideoResnet(nm, ch, ch)
        self.mid.attn_1 = VAttn(nm, ch)
        self.mid.block_2 = VideoResnet(nm, ch, ch)
        levels = [None] * len(cfg.channel_mult)
        for i in reversed(range(len(cfg.channel_mult))):
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(VideoResnet(nm, ch, base * cfg.channel_mult[i]))
                ch = base * cfg.channel_mult[i]
            levels[i] = VLevel(blocks, "upsample",
                               Upsample(nm, ch) if i != 0 else None)
        self.up = nn.ModuleList(levels)
        self.norm_out = GroupNorm(ch, 1e-6)
        self.conv_out = Conv(nm, ch, cfg.out_channels, 3, padding=1)
        self.conv_out.time_mix_conv = TConv3(nm, cfg.out_channels)

    def forward(self, z, t):
        h = self.mid.block_1(self.conv_in(z), t)
        h = self.mid.block_2(self.mid.attn_1(h), t)
        for level in reversed(self.up):
            for blk in level.block:
                h = blk(h, t)
            if level.resample_name:
                h = level.upsample(h)
        y = self.conv_out(self.norm_out(h, True))
        return self.conv_out.time_mix_conv(y.reshape(-1, t, *y.shape[1:])
                                           ).reshape(y.shape)


class PooledVisionEncoder(VisionEncoder):
    """OpenCLIP ViT with ln_post and proj on the class token."""

    def __init__(self, nm, cfg):
        super().__init__(nm, cfg)
        self.nm = nm
        self.ln_post = LayerNorm(cfg.width)
        self.proj = _p(cfg.width, cfg.output_dim)

    def pooled(self, images):
        cls = self.ln_post(self(images)[:, 0])
        return self.nm.op(cls) @ self.nm.op(self.proj)


CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class SVD(nn.Module):
    """Submodules under the released state-dict prefixes."""

    def __init__(self, config: dict, nm: Optional[Numerics] = None):
        super().__init__()
        nm = nm or Numerics()
        self.nm = nm
        self.cfg = {k: _ns(v) for k, v in config.items()
                    if isinstance(v, dict)}
        self.cond_scale_factor = config.get("cond_scale_factor", 1.0)
        c = self.cfg
        self.model = nn.Module()
        self.model.diffusion_model = VideoUNet(nm, c["video_unet"])
        self.first_stage_model = nn.Module()
        self.first_stage_model.decoder = VideoDecoder(nm, c["vae"])
        clip, enc = nn.Module(), nn.Module()
        clip.open_clip = nn.Module()
        clip.open_clip.model = nn.Module()
        clip.open_clip.model.visual = PooledVisionEncoder(nm, c["clip_image"])
        enc.encoder = nn.Module()
        enc.encoder.encoder = Encoder(nm, c["vae"])
        z2 = 2 * c["vae"].z_channels
        enc.encoder.quant_conv = Pointwise(nm, z2, z2)
        self.conditioner = nn.Module()
        self.conditioner.embedders = nn.ModuleDict({"0": clip, "3": enc})

    @property
    def device(self):
        return self.model.diffusion_model.out["2"].weight.device

    @property
    def dtype(self):
        return self.model.diffusion_model.out["2"].weight.dtype

    def encode_image(self, images):
        """images (b, h, w, 3) in [0, 1] -> (b, 1, output_dim)."""
        size = self.cfg["clip_image"].image_size
        x = F.interpolate(images.float().permute(0, 3, 1, 2),
                          size=(size, size), mode="bilinear",
                          align_corners=False, antialias=True)
        x = x.permute(0, 2, 3, 1)
        mean = torch.tensor(CLIP_MEAN, device=x.device)
        std = torch.tensor(CLIP_STD, device=x.device)
        tower = self.conditioner.embedders["0"].open_clip.model.visual
        return tower.pooled(((x - mean) / std).to(self.dtype))[:, None]

    def encode_frame(self, frame):
        """frame (b, h, w, 3) in [-1, 1] -> the posterior mode, scaled."""
        enc = self.conditioner.embedders["3"].encoder
        mom = enc.quant_conv(enc.encoder(frame.to(self.dtype)))
        return mom.chunk(2, dim=-1)[0] * self.cond_scale_factor

    def vector(self, b):
        s, d = self.cfg["edm"], self.cfg["video_unet"].adm_in_channels // 3
        v = torch.tensor([s.fps_id, s.motion_bucket_id, s.cond_aug],
                         device=self.device)
        return sinusoidal(v, d).reshape(1, -1).expand(b, -1)

    def conditioning(self, image, cond_frame):
        """Both CFG streams, unconditional first (zero context and concat
        latent), as LinearPredictionGuider.prepare_inputs stacks them."""
        ctx = self.encode_image(image)
        z = self.encode_frame(cond_frame)
        vec = self.vector(image.shape[0])
        return {"context": torch.cat([torch.zeros_like(ctx), ctx]),
                "concat": torch.cat([torch.zeros_like(z), z]),
                "vector": torch.cat([vec, vec])}

    def denoise(self, x, sigma, cond):
        """Denoiser with VScalingWithEDMcNoise on x (2b, t, h, w, z):
        network(x c_in ++ concat, c_noise) c_out + x c_skip."""
        c_skip, c_out, c_in, c_noise = v_scaling(sigma)
        b2, t = x.shape[:2]
        concat = cond["concat"][:, None].expand(-1, t, -1, -1, -1)
        x_in = torch.cat([x * c_in, concat.to(x.dtype)], dim=-1)
        out = self.model.diffusion_model(
            x_in.to(self.dtype), c_noise.reshape(1).expand(b2),
            cond["context"].to(self.dtype), cond["vector"])
        return out.float() * c_out + x * c_skip

    def decode(self, z):
        """(b, T, h, w, z) -> (b, T, 8h, 8w, 3): z / scale_factor, the
        (b T) frames in chunks of decoding_t, each chunk one video."""
        b, t = z.shape[:2]
        flat = (z / self.cfg["vae"].scale_factor).reshape(b * t,
                                                          *z.shape[2:])
        n = self.cfg["edm"].decoding_t
        dec = self.first_stage_model.decoder
        out = [dec(flat[s:s + n].to(self.dtype), len(flat[s:s + n]))
               for s in range(0, b * t, n)]
        y = torch.cat(out)
        return y.reshape(b, t, *y.shape[1:])


# -- EDM sampling ---------------------------------------------------------


def karras_sigmas(steps, sigma_min, sigma_max, rho, device=None):
    """EDMDiscretization with the trailing zero: (steps + 1,) float32."""
    ramp = torch.linspace(0, 1, steps, device=device)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    sigmas = (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho
    return torch.cat([sigmas, sigmas.new_zeros([1])])


def v_scaling(sigma):
    c_skip = 1.0 / (sigma ** 2 + 1.0)
    c_out = -sigma / (sigma ** 2 + 1.0) ** 0.5
    c_in = 1.0 / (sigma ** 2 + 1.0) ** 0.5
    c_noise = 0.25 * sigma.log()
    return c_skip, c_out, c_in, c_noise


def guide(denoised, min_scale, max_scale):
    """LinearPredictionGuider: (2b, t, ...) unconditional first ->
    x_u + scale_t (x_c - x_u), scale linear over the t frames."""
    x_u, x_c = denoised.chunk(2)
    t = x_u.shape[1]
    scale = torch.linspace(min_scale, max_scale, t, device=x_u.device)
    scale = scale.reshape(1, t, *([1] * (x_u.ndim - 2)))
    return x_u + scale * (x_c - x_u)


def euler(x, denoised, sigma, next_sigma):
    """EulerEDMSampler's step with s_churn 0."""
    d = (x - denoised) / sigma
    return x + (next_sigma - sigma) * d


def start(shape, sigma0, generator, device):
    """The noised start: randn (float32) times sqrt(1 + sigma_0^2)."""
    x = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return x * torch.sqrt(1.0 + sigma0 ** 2.0)


@torch.no_grad()
def sample(m: SVD, cond: dict, x: torch.Tensor, sigmas: torch.Tensor
           ) -> torch.Tensor:
    """Euler over `sigmas` from the noised start x (b, t, h, w, z)."""
    s = m.cfg["edm"]
    for i in range(len(sigmas) - 1):
        d = guide(m.denoise(torch.cat([x, x]), sigmas[i], cond),
                  s.min_guidance_scale, s.max_guidance_scale)
        x = euler(x, d, sigmas[i], sigmas[i + 1])
    return x
