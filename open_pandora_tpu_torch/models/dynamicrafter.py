"""DynamiCrafter image-to-video: UNet3D + VAE + OpenCLIP text and image
encoders + Resampler, with DDIM sampling.

Counterpart of open_pandora_tpu/models/dynamicrafter.py. The submodules sit
under the reference state-dict prefixes (`model.diffusion_model.`,
`first_stage_model.`, `cond_stage_model.model.`, `embedder.model.visual.`,
`image_proj_model.`), so a converted checkpoint loads with
load_state_dict(strict=True).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from open_pandora_tpu_torch.core.config import PandoraConfig
from open_pandora_tpu_torch.diffusion.ddim import (NoiseFn, ddim_sample,
                                                   make_cfg_model_fn,
                                                   make_ddim_schedule)
from open_pandora_tpu_torch.diffusion.schedule import make_schedule
from open_pandora_tpu_torch.models.encoders import (CLIPTextEncoder,
                                                    CLIPVisionEncoder,
                                                    Resampler,
                                                    clip_preprocess,
                                                    empty_prompt_tokens)
from open_pandora_tpu_torch.models.unet3d import UNetModel
from open_pandora_tpu_torch.models.vae import (AutoencoderKL, decode_video,
                                               encode_video)


class _Prefix(nn.Module):
    """Holds submodules under the names the reference state dict uses."""

    def __init__(self, **modules: nn.Module):
        super().__init__()
        for name, mod in modules.items():
            self.add_module(name, mod)


class DynamiCrafter(nn.Module):
    """The composite model. Construct it on the meta device and materialise
    it with `to_empty`, then load weights or call core.init.init_random_."""

    def __init__(self, cfg: PandoraConfig):
        super().__init__()
        self.cfg = cfg
        self.model = _Prefix(diffusion_model=UNetModel(cfg.unet))
        self.first_stage_model = AutoencoderKL(cfg.vae)
        self.cond_stage_model = _Prefix(model=CLIPTextEncoder(cfg.clip_text))
        self.embedder = _Prefix(model=_Prefix(
            visual=CLIPVisionEncoder(cfg.clip_vision)))
        self.image_proj_model = Resampler(cfg.resampler)
        self.schedule = make_schedule(cfg.diffusion)

    @property
    def dtype(self) -> torch.dtype:
        return self.image_proj_model.latents.dtype

    @property
    def device(self) -> torch.device:
        return self.image_proj_model.latents.device

    # -- conditioning -------------------------------------------------------

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(b, 77) ids -> (b, 77, width) penultimate-layer embedding."""
        return self.cond_stage_model.model(token_ids.to(self.device))

    def encode_image_context(self, images: torch.Tensor) -> torch.Tensor:
        """images (b, h, w, 3) in [0, 1] -> (b, num_queries*video_length,
        output_dim) cross-attention image tokens."""
        x = clip_preprocess(images.to(self.device, self.dtype),
                            size=self.cfg.clip_vision.image_size)
        return self.image_proj_model(self.embedder.model.visual(x))

    def get_latent_z(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (b, t_cond, h, w, 3) in [-1, 1] -> (b, T, h/8, w/8, 4)
        conditioning latents: t=1 is tiled x4, then to temporal_length."""
        T = self.cfg.unet.temporal_length
        z = encode_video(self.first_stage_model,
                         frames.to(self.device, self.dtype),
                         scale_factor=self.cfg.diffusion.scale_factor)
        if z.shape[1] == 1:
            z = z.repeat(1, 4, 1, 1, 1)
        return z.repeat(1, T // z.shape[1], 1, 1, 1)

    # -- denoiser -----------------------------------------------------------

    def apply_model(self, x_noisy: torch.Tensor, t: torch.Tensor,
                    context: torch.Tensor, concat_cond: torch.Tensor,
                    fs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hybrid conditioning: channel-concat the cond latents,
        cross-attend the context."""
        x_in = torch.cat([x_noisy, concat_cond], dim=-1)
        return self.model.diffusion_model(x_in, t, context, fs=fs)

    # -- sampling -----------------------------------------------------------

    def image_guided_synthesis(
        self, *, text_context: torch.Tensor, cond_images: torch.Tensor,
        cond_frames: torch.Tensor, ddim_steps: int = 50,
        guidance_scale: float = 7.5, eta: float = 1.0, fs: int = 15,
        guidance_rescale: float = 0.0,
        timestep_spacing: str = "uniform_trailing",
        uncond_text_context: Optional[torch.Tensor] = None,
        cfg_img: Optional[float] = None,
        generator: Optional[torch.Generator] = None,
        x_T: Optional[torch.Tensor] = None,
        noise: Union[None, NoiseFn, Sequence[torch.Tensor]] = None,
        _apply_model: Optional[Callable] = None,
    ) -> torch.Tensor:
        """Latents (b, T, h/8, w/8, 4). Conditioning: the text context, the
        CLIP image context of cond_images ([0, 1]) and the VAE latents of
        cond_frames ([-1, 1]); the uncond stream pairs the empty prompt with
        a zero image. x_T and the per-step noise are drawn from `generator`
        unless given. `_apply_model(x, t, ctx, concat, fs)` stands in for
        apply_model (parallel/sharded_infer.py shards the CFG-stream batch
        with it)."""
        streams = self.synthesis_streams(
            text_context=text_context, cond_images=cond_images,
            cond_frames=cond_frames, guidance_scale=guidance_scale,
            uncond_text_context=uncond_text_context, cfg_img=cfg_img, fs=fs)
        return self.sample(streams, ddim_steps=ddim_steps,
                           guidance_scale=guidance_scale, eta=eta,
                           guidance_rescale=guidance_rescale,
                           timestep_spacing=timestep_spacing, cfg_img=cfg_img,
                           generator=generator, x_T=x_T, noise=noise,
                           _apply_model=_apply_model)

    def synthesis_streams(self, *, text_context: torch.Tensor,
                          cond_images: torch.Tensor, cond_frames: torch.Tensor,
                          guidance_scale: float,
                          uncond_text_context: Optional[torch.Tensor] = None,
                          cfg_img: Optional[float] = None,
                          fs: int = 15) -> dict:
        """The encoder pass of image_guided_synthesis: the CLIP image
        context, the VAE conditioning latents and each CFG stream's
        cross-attention context."""
        cfg = self.cfg
        b = text_context.shape[0]
        text_context = text_context.to(self.device, self.dtype)
        img_ctx = self.encode_image_context(cond_images)
        z_cond = self.get_latent_z(cond_frames)
        cond_ctx = torch.cat([text_context, img_ctx], dim=1)

        uncond_ctx = uncond_img_ctx = None
        if guidance_scale != 1.0:
            if uncond_text_context is None:
                uncond_text_context = self.encode_text(empty_prompt_tokens(
                    b, cfg.clip_text.context_length, device=self.device))
            uncond_text_context = uncond_text_context.to(self.device,
                                                         self.dtype)
            uc_img_ctx = self.encode_image_context(
                torch.zeros_like(cond_images))
            uncond_ctx = torch.cat([uncond_text_context, uc_img_ctx], dim=1)
            if cfg_img is not None and cfg_img != 1.0:
                uncond_img_ctx = torch.cat([uncond_text_context, img_ctx],
                                           dim=1)
        return {"cond_ctx": cond_ctx, "uncond_ctx": uncond_ctx,
                "uncond_img_ctx": uncond_img_ctx, "z_cond": z_cond,
                "fs": torch.full((b,), fs, dtype=torch.int64,
                                 device=self.device)}

    def sample(self, streams: dict, *, ddim_steps: int = 50,
               guidance_scale: float = 7.5, eta: float = 1.0,
               guidance_rescale: float = 0.0,
               timestep_spacing: str = "uniform_trailing",
               cfg_img: Optional[float] = None,
               generator: Optional[torch.Generator] = None,
               x_T: Optional[torch.Tensor] = None,
               noise: Union[None, NoiseFn, Sequence[torch.Tensor]] = None,
               _apply_model: Optional[Callable] = None,
               ) -> torch.Tensor:
        """The DDIM loop of image_guided_synthesis over precomputed
        streams: one batched-CFG UNet eval per step (through
        `_apply_model` when given)."""
        cfg = self.cfg
        z_cond, fs_arr = streams["z_cond"], streams["fs"]
        b = z_cond.shape[0]
        raw_apply = _apply_model or self.apply_model

        def apply(x, t, ctx):
            reps = x.shape[0] // b
            return raw_apply(x, t, ctx, torch.cat([z_cond] * reps),
                             torch.cat([fs_arr] * reps))

        model_fn = make_cfg_model_fn(apply, streams["cond_ctx"],
                                     streams["uncond_ctx"],
                                     uncond_img=streams["uncond_img_ctx"],
                                     batched_cfg=cfg.sampler.batched_cfg)
        dd = make_ddim_schedule(
            self.schedule, ddim_steps, eta, timestep_spacing,
            use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale)
        if x_T is None:
            if generator is None:
                raise ValueError("sample: pass `x_T` or a `generator`")
            x_T = torch.randn((b, *z_cond.shape[1:4], cfg.vae.z_channels),
                              generator=generator, device=self.device,
                              dtype=self.dtype)
        return ddim_sample(
            model_fn, dd, x_T.to(self.device, self.dtype), noise=noise,
            generator=generator, guidance_scale=guidance_scale,
            cfg_img=(cfg_img if streams["uncond_img_ctx"] is not None
                     else None),
            guidance_rescale=guidance_rescale,
            parameterization=cfg.diffusion.parameterization)

    def decode(self, z: torch.Tensor, frame_chunk: int = 1) -> torch.Tensor:
        """latents -> video (b, t, h, w, 3), about [-1, 1] (unclamped)."""
        return decode_video(self.first_stage_model, z.to(self.dtype),
                            scale_factor=self.cfg.diffusion.scale_factor,
                            frame_chunk=frame_chunk)
