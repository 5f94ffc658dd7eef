"""Plain PyTorch reference of Stable Video Diffusion XT image-to-video:
the VideoUNet with its preconditioning, the conditioning (OpenCLIP ViT-H's
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
with float32 statistics. It imports nothing of the program. Blocks shared
with DynamiCrafter come from reference/model.py, with its `Numerics` (fp32
with TF32 off for the reference, fp8 operands for the control).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from reference.model import (CrossAttention, Conv, Downsample, Encoder,
                             FeedForward, GroupNorm, LayerNorm, Linear,
                             Numerics, Pointwise, ResBlock, TConv3,
                             TransformerBlock, Upsample, VAttn, VisionEncoder,
                             VLevel, VResBlock, _list, _ns, _p)

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
