"""Stable Video Diffusion XT image-to-video: the VideoUNet, the SD VAE
encoder of the concat latent and the temporal VideoDecoder, OpenCLIP
ViT-H's pooled image embedding and the vector conditioning, with EDM
sampling (diffusion/edm.py). Channel-last, as the rest of the port.

Follows Stability-AI generative-models (svd_xt.yaml;
sgm/modules/diffusionmodules/video_model.py, sgm/modules/video_attention.py,
sgm/modules/encoders/modules.py): one video of t frames is the UNet's
batch row; every spatial ResBlock is followed by a time-stack ResBlock of
(3, 1, 1) convolutions, and every spatial transformer block by a
VideoTransformerBlock over t (GEGLU `ff_in`, self-attention, cross-attention
to the image embedding, GEGLU `ff`) on the stream plus a sinusoidal frame
embedding, each blended in as alpha spatial + (1 - alpha) temporal with
alpha = sigmoid(mix_factor) (`learned_with_images`, video frames only).

The DynamiCrafter classes this reuses run unchanged: ResBlock (with no
temporal conv), CrossAttention, BasicTransformerBlock's feed-forward (row
13 on the fused route, for `ff_in` too), GroupNorm32 (rows 5 and 6), the
input and resampling convs. The cross-attention context is a single token
(the image embedding), so softmax over its one key is 1 and both attn2
sites reduce to to_out(to_v(context)), exactly: the port computes that and
skips the query side. The temporal self-attention (t = 25) takes the
attention dispatcher (the small-attention kernel, row 2, on a CUDA
device); the fused temporal kernel (row 4) admits its 320- and
640-channel sites but lost to this route there on the H100 (chip_smoke
phase 3, `check_svd_sites`).

Parameter names follow the released state dict
(`model.diffusion_model.input_blocks.1.0.time_stack.in_layers.2.weight`,
`...1.1.time_stack.0.ff_in.net.0.proj.weight`,
`conditioner.embedders.0.open_clip.model.visual.proj`,
`conditioner.embedders.3.encoder.quant_conv.weight`,
`first_stage_model.decoder.up.0.block.0.mix_factor`, ...).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import SVDConfig, VideoUNetConfig
from open_pandora_tpu_torch.diffusion import edm
from open_pandora_tpu_torch.models.encoders import (CLIPVisionEncoderPooled,
                                                    clip_preprocess)
from open_pandora_tpu_torch.models.layers import (Conv2d, GroupNorm32,
                                                  LayerNorm, PointwiseConv,
                                                  SConv3x3)
from open_pandora_tpu_torch.models.unet3d import (BasicTransformerBlock,
                                                  CrossAttention, Downsample,
                                                  FeedForward, ResBlock,
                                                  Upsample, geglu_residual)
from open_pandora_tpu_torch.models.vae import (DiagonalGaussian, Encoder,
                                               TimeStackResBlock, VideoDecoder,
                                               alpha_blend,
                                               decode_video_chunks)
from open_pandora_tpu_torch.utils.profiling import span


def sinusoidal(t: torch.Tensor, dim: int,
               max_period: int = 10000) -> torch.Tensor:
    """sgm's timestep_embedding: (n,) -> (n, dim) float32, [cos | sin],
    frequencies computed in float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(0, half, dtype=torch.float32) / half)
    args = t.float()[:, None] * freqs.to(t.device)[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def context_token(attn: CrossAttention, context: torch.Tensor
                  ) -> torch.Tensor:
    """attn(q, context) for a one-token context: the softmax over one key is
    1, so every query reads to_out(to_v(context)), (B, 1, dim), whatever
    the query."""
    return attn.to_out[0](attn.to_v(context))


class AlphaBlender(nn.Module):
    """`learned_with_images` on video frames: alpha x_spatial +
    (1 - alpha) x_temporal, alpha = sigmoid(mix_factor)."""

    def __init__(self):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.empty(1))

    def forward(self, x_spatial: torch.Tensor,
                x_temporal: torch.Tensor) -> torch.Tensor:
        return alpha_blend(self.mix_factor, x_spatial, x_temporal)


class VideoResBlock(ResBlock):
    """The spatial ResBlock (no temporal conv), then the time stack over
    each video's t frames with the per-frame embedding, blended."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int):
        super().__init__(in_ch, out_ch, emb_dim, use_temporal_conv=False,
                         dropout=0.0)
        self.time_stack = TimeStackResBlock(out_ch, emb_dim)
        self.time_mixer = AlphaBlender()

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        h = super().forward(x, emb, batch_size)
        with span("unet.time_stack"):
            bt = h.shape[0]
            hv = h.reshape(batch_size, bt // batch_size, *h.shape[1:])
            ht = self.time_stack(hv, emb.reshape(*hv.shape[:2], -1))
            return self.time_mixer(hv, ht).reshape(h.shape)


class SpatialVideoBlock(BasicTransformerBlock):
    """sgm's BasicTransformerBlock with a one-token context:
    self-attention, the context token's value, the GEGLU feed-forward."""

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + context_token(self.attn2, context)
        return self.feed_forward(x)


class VideoTransformerBlock(BasicTransformerBlock):
    """sgm's VideoTransformerBlock (ff_in, is_res) on the native
    (b, t, s, c) stream: x + ff_in(norm_in(x)), self-attention over t,
    the context token's value, x + ff(norm3(x))."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: int):
        super().__init__(dim, heads, dim_head, context_dim=context_dim)
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)

    def self_attention(self, x: torch.Tensor) -> torch.Tensor:
        """x + attn1(norm1(x)) over the t axis of x (b, t, s, c), on the
        transposed (b s, t, c) stream."""
        b, t, s, c = x.shape
        xt = x.transpose(1, 2).reshape(b * s, t, c)
        xt = xt + self.attn1(self.norm1(xt))
        return xt.reshape(b, s, t, c).transpose(1, 2)

    def forward(self, x: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        """x (b, t, s, c); context (b, 1, context_dim)."""
        x = geglu_residual(self, x, self.norm_in, self.ff_in)
        x = self.self_attention(x)
        x = x + context_token(self.attn2, context)[:, :, None, :]
        return self.feed_forward(x)


class SpatialVideoTransformer(nn.Module):
    """sgm's SpatialVideoTransformer (use_linear, use_spatial_context): per
    depth, the spatial block over each frame's h w tokens, then the
    temporal block over t on the stream plus the frame embedding, blended
    in. The temporal cross-attention reads each video's first-frame
    context."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 context_dim: int):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch, 1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            SpatialVideoBlock(inner, heads, dim_head, context_dim=context_dim)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, ch)
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(inner, heads, dim_head, context_dim)
            for _ in range(depth))
        self.time_pos_embed = nn.ModuleList([nn.Linear(ch, 4 * ch), nn.SiLU(),
                                             nn.Linear(4 * ch, ch)])
        self.time_mixer = AlphaBlender()

    def frame_embedding(self, t: int, ref: torch.Tensor) -> torch.Tensor:
        """(t, ch): the frame index's sinusoid through time_pos_embed."""
        e = sinusoidal(torch.arange(t, device=ref.device),
                       self.proj_in.in_features)
        lin = self.time_pos_embed
        return lin[2](F.silu(lin[0](e.to(ref.dtype))))

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        """x (b t, h, w, c); context (b t, 1, context_dim)."""
        bt, h, w, c = x.shape
        t = bt // batch_size
        y = self.proj_in(self.norm(x).reshape(bt, h * w, c))
        time_ctx = context.reshape(batch_size, t, *context.shape[1:])[:, 0]
        for blk, mix in zip(self.transformer_blocks, self.time_stack):
            y = blk(y, context)
            with span("unet.video_transformer"):
                yv = y.reshape(batch_size, t, h * w, y.shape[-1])
                ym = yv + self.frame_embedding(t, yv)[None, :, None, :]
                y = self.time_mixer(yv, mix(ym, time_ctx)).reshape(y.shape)
        return x + self.proj_out(y).reshape(bt, h, w, c)


class VideoUNet(nn.Module):
    """x (b, t, h, w, c_in), c_noise (b,), context (b, 1, context_dim),
    vector y (b, adm_in_channels) -> (b, t, h, w, out_channels). Every
    frame of a video shares its noise level, context and vector."""

    def __init__(self, cfg: VideoUNetConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.ModuleList([nn.Linear(mc, ted), nn.SiLU(),
                                         nn.Linear(ted, ted)])
        self.label_emb = nn.ModuleList([nn.ModuleList([
            nn.Linear(cfg.adm_in_channels, ted), nn.SiLU(),
            nn.Linear(ted, ted)])])

        def attention(ch):
            return SpatialVideoTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                cfg.transformer_depth, cfg.context_dim)

        inputs = [nn.ModuleList([SConv3x3(cfg.in_channels, mc)])]
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                block = [VideoResBlock(ch, mult * mc, ted)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(attention(ch))
                inputs.append(nn.ModuleList(block))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                inputs.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(inputs)
        self.middle_block = nn.ModuleList([VideoResBlock(ch, ch, ted),
                                           attention(ch),
                                           VideoResBlock(ch, ch, ted)])
        outputs = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                block = [VideoResBlock(ch + chans.pop(), mult * mc, ted)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(attention(ch))
                if level and i == cfg.num_res_blocks:
                    block.append(Upsample(ch))
                    ds //= 2
                outputs.append(nn.ModuleList(block))
        self.output_blocks = nn.ModuleList(outputs)
        self.out = nn.ModuleList([GroupNorm32(ch, 1e-5), nn.SiLU(),
                                  Conv2d(ch, cfg.out_channels, 3, padding=1)])

    def _run(self, block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
             ctx: torch.Tensor, b: int) -> torch.Tensor:
        for layer in block:
            if isinstance(layer, VideoResBlock):
                with span("unet.resblock"):
                    h = layer(h, emb, b)
            elif isinstance(layer, SpatialVideoTransformer):
                with span("unet.spatial"):
                    h = layer(h, ctx, b)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, c_noise: torch.Tensor,
                context: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        with span("unet"):
            return self._forward(x, c_noise, context, y)

    def _forward(self, x, c_noise, context, y):
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        dt = self.out[2].weight.dtype
        te, le = self.time_embed, self.label_emb[0]
        emb = te[2](F.silu(te[0](sinusoidal(c_noise, cfg.model_channels
                                            ).to(dt))))
        emb = emb + le[2](F.silu(le[0](y.to(dt))))
        emb = emb.repeat_interleave(t, dim=0)
        ctx = context.to(dt).repeat_interleave(t, dim=0)
        h = self.input_blocks[0][0](x.reshape(b * t, hh, ww, -1).to(dt),
                                    fast=not self.training)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, emb, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, b)
        for block in self.output_blocks:
            h = self._run(block, torch.cat([h, hs.pop()], dim=-1), emb, ctx,
                          b)
        out = self.out[2](self.out[0](h, silu=True))
        return out.reshape(b, t, hh, ww, cfg.out_channels)


class _Prefix(nn.Module):
    """Holds submodules under the names the released state dict uses."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            self.add_module(name, mod)


class StableVideoDiffusion(nn.Module):
    """The composite model. Construct it on the meta device and materialise
    it with `to_empty`, then load weights or call core.init.init_random_."""

    def __init__(self, cfg: SVDConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _Prefix(diffusion_model=VideoUNet(cfg.video_unet))
        self.first_stage_model = _Prefix(decoder=VideoDecoder(cfg.vae))
        z2 = 2 * cfg.vae.z_channels
        self.conditioner = _Prefix(embedders=nn.ModuleDict({
            "0": _Prefix(open_clip=_Prefix(model=_Prefix(
                visual=CLIPVisionEncoderPooled(cfg.clip_image)))),
            "3": _Prefix(encoder=_Prefix(encoder=Encoder(cfg.vae),
                                         quant_conv=PointwiseConv(z2, z2)))}))

    @property
    def dtype(self) -> torch.dtype:
        return self.model.diffusion_model.out[2].weight.dtype

    @property
    def device(self) -> torch.device:
        return self.model.diffusion_model.out[2].weight.device

    # -- conditioning -------------------------------------------------------

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        """images (b, h, w, 3) in [0, 1] -> (b, 1, output_dim): the pooled
        ViT-H embedding of the unnoised image."""
        tower = self.conditioner.embedders["0"].open_clip.model.visual
        x = clip_preprocess(images.to(self.device, self.dtype),
                            size=self.cfg.clip_image.image_size)
        return tower.pooled(x)[:, None]

    def encode_frame(self, frame: torch.Tensor) -> torch.Tensor:
        """frame (b, h, w, 3) in [-1, 1] (noised by cond_aug) -> the
        posterior mode of the conditioning encoder, (b, h/8, w/8, z), times
        cond_scale_factor."""
        enc = self.conditioner.embedders["3"].encoder
        moments = enc.quant_conv(enc.encoder(frame.to(self.device,
                                                      self.dtype)))
        return (DiagonalGaussian.from_params(moments).mode()
                * self.cfg.cond_scale_factor)

    def vector(self, b: int) -> torch.Tensor:
        """(b, adm_in_channels) float32: fps_id, motion_bucket_id and
        cond_aug, each embedded sinusoidally at a third of the width."""
        s, d = self.cfg.edm, self.cfg.video_unet.adm_in_channels // 3
        v = torch.tensor([s.fps_id, s.motion_bucket_id, s.cond_aug],
                         device=self.device)
        return sinusoidal(v, d).reshape(1, -1).expand(b, -1)

    def conditioning(self, image: torch.Tensor, cond_frame: torch.Tensor
                     ) -> dict:
        """image (b, h, w, 3) in [0, 1]; cond_frame (b, h, w, 3), the
        diffusion frame plus cond_aug noise. The two CFG streams stacked on
        the batch axis, unconditional first: context (2b, 1, C) with the
        unconditional rows zero, the concat latent (2b, h/8, w/8, z) with
        the unconditional rows zero, the vector (2b, adm) alike in both."""
        ctx = self.encode_image(image)
        z = self.encode_frame(cond_frame)
        vec = self.vector(image.shape[0])
        return {"context": torch.cat([torch.zeros_like(ctx), ctx]),
                "concat": torch.cat([torch.zeros_like(z), z]),
                "vector": torch.cat([vec, vec])}

    # -- denoiser -----------------------------------------------------------

    def denoise(self, x: torch.Tensor, sigma: torch.Tensor, cond: dict
                ) -> torch.Tensor:
        """The preconditioned denoiser on stacked streams: x (2b, t, h, w,
        z) float32, sigma a float32 scalar -> D (2b, t, h, w, z) float32.
        The concat latent joins the scaled input unscaled."""
        c_skip, c_out, c_in, c_noise = edm.v_scaling(sigma)
        t = x.shape[1]
        concat = cond["concat"][:, None].expand(-1, t, -1, -1, -1)
        x_in = torch.cat([(x * c_in).to(self.dtype), concat.to(self.dtype)],
                         dim=-1)
        out = self.model.diffusion_model(
            x_in, c_noise.reshape(1).expand(x.shape[0]), cond["context"],
            cond["vector"])
        return out.float() * c_out + x * c_skip

    # -- sampling -----------------------------------------------------------

    def sigmas(self, steps: Optional[int] = None) -> torch.Tensor:
        s = self.cfg.edm
        return edm.karras_sigmas(steps or s.steps, s.sigma_min, s.sigma_max,
                                 s.rho, device=self.device)

    def sample(self, cond: dict, *, generator: torch.Generator,
               steps: Optional[int] = None,
               frames: Optional[int] = None) -> torch.Tensor:
        """EDM Euler from a draw of `generator`: latents (b, t, h/8, w/8, z)
        float32."""
        s = self.cfg.edm
        t = frames or self.cfg.video_unet.num_frames
        z = cond["concat"]
        b = z.shape[0] // 2
        sig = self.sigmas(steps)
        x = torch.randn((b, t, *z.shape[1:]), generator=generator,
                        device=self.device, dtype=torch.float32)
        x = x * torch.sqrt(1.0 + sig[0] ** 2.0)
        scale = edm.guidance_scale(s.min_guidance_scale,
                                   s.max_guidance_scale, t,
                                   device=self.device)
        return edm.edm_sample(lambda x2, sigma: self.denoise(x2, sigma, cond),
                              x, sig, scale)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents (b, t, h, w, z) -> video (b, t, 8h, 8w, 3), about
        [-1, 1] (unclamped), in chunks of decoding_t frames."""
        return decode_video_chunks(
            self.first_stage_model.decoder, z.to(self.dtype),
            scale_factor=self.cfg.vae.scale_factor,
            chunk=self.cfg.edm.decoding_t)
