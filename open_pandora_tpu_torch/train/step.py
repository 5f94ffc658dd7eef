"""The DynamiCrafter finetune train step, on one device.

Counterpart of `make_finetune_step` and `_finetune_loss` in
open_pandora_tpu/train/step.py (reference model.py:926-949 training_step
and get_batch_input :828-884): VAE-encoded video latents sampled from the
posterior, text and image conditioning, CFG dropout of the text context
to the empty prompt, the frame-stride condition from the batch, and the
diffusion loss; then the clipped AdamW update and the optional EMA.

Batch contract (as the JAX package's):
  video        (b, T, H, W, 3) in [-1, 1]
  cond_frames  (b, t_c, H, W, 3) in [-1, 1]  VAE conditioning frames
  cond_images  (b, hc, wc, 3) in [0, 1]      CLIP image for cross-attn
  text_tokens  (b, L) int                    tokenized caption
  fps          (b,) int

The random draws (posterior noise `eps`, CFG dropout mask `uncond`,
timesteps `t`, diffusion `noise`) come from an explicit torch.Generator
or from the caller's `draws` dict. Dropout inside the UNet draws from the
global RNG (see models/unet3d.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.diffusion.losses import diffusion_loss
from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu_torch.models.encoders import empty_prompt_tokens
from open_pandora_tpu_torch.models.vae import encode_video
from open_pandora_tpu_torch.train.ema import EMA
from open_pandora_tpu_torch.train.optim import Optimizer, trainable_partition

DRAWS = ("eps", "uncond", "t", "noise")


@dataclass
class TrainState:
    """The step count, the model (its trainable parameters updated in
    place), the optimizer over them, and the optional EMA shadow."""

    step: int
    model: DynamiCrafter
    trainable: Dict[str, torch.Tensor]
    optimizer: Optimizer
    ema: Optional[EMA] = None

    @classmethod
    def create(cls, model: DynamiCrafter, stage: str,
               tcfg: TrainConfig) -> "TrainState":
        trainable, _ = trainable_partition(model, stage)
        return cls(step=0, model=model, trainable=trainable,
                   optimizer=Optimizer(trainable, tcfg),
                   ema=EMA(trainable) if tcfg.use_ema else None)


def _finetune_loss(model: DynamiCrafter, tcfg: TrainConfig,
                   batch: Dict[str, torch.Tensor], *,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None):
    draws = draws or {}
    if generator is None and not set(DRAWS) <= draws.keys():
        raise ValueError(f"_finetune_loss: pass a generator or all of "
                         f"{DRAWS} in draws")
    cfg = model.cfg
    dev, dt = model.device, model.dtype
    with torch.no_grad():
        # clean latents: the reference SAMPLES the posterior in training
        # (ddpm3d.py:595-602)
        z = encode_video(model.first_stage_model, batch["video"].to(dev, dt),
                         scale_factor=cfg.diffusion.scale_factor,
                         generator=generator, eps=draws.get("eps"))
        text_ctx = model.encode_text(batch["text_tokens"])
        img_ctx = model.encode_image_context(batch["cond_images"])
        z_cond = model.get_latent_z(batch["cond_frames"])
        # CFG dropout on the text conditioning only (model.py:860-868)
        if tcfg.uncond_prob > 0:
            b = text_ctx.shape[0]
            null_ctx = model.encode_text(empty_prompt_tokens(
                b, cfg.clip_text.context_length, device=dev))
            mask = draws.get("uncond")
            if mask is None:
                mask = torch.rand((b,), generator=generator,
                                  device=dev) < tcfg.uncond_prob
            text_ctx = torch.where(mask.to(dev).reshape(b, 1, 1), null_ctx,
                                   text_ctx)
        ctx = torch.cat([text_ctx, img_ctx], dim=1)
        fs = batch["fps"].to(dev, torch.int64)

    def apply(x_noisy, t):
        return model.apply_model(x_noisy, t, ctx, z_cond, fs=fs)

    return diffusion_loss(
        apply, model.schedule, z, generator=generator, t=draws.get("t"),
        noise=draws.get("noise"),
        parameterization=cfg.diffusion.parameterization,
        use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
        l_simple_weight=cfg.diffusion.l_simple_weight)


def make_finetune_step(model: DynamiCrafter, tcfg: TrainConfig,
                       stage: str = "dynamicrafter") -> Callable:
    """step(state, batch, *, generator=None, draws=None) -> metrics
    {loss, loss_simple, grad_norm} (0-dim tensors on the model's device;
    grad_norm is the norm before clipping). Updates state in place."""
    if stage != "dynamicrafter":
        raise NotImplementedError(
            f"stage {stage!r}: the LLM-conditioned stages wait for slice B")

    def step(state: TrainState, batch, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        state.optimizer.zero_grad()
        loss, metrics = _finetune_loss(model, tcfg, batch,
                                       generator=generator, draws=draws)
        loss.backward()
        gnorm = state.optimizer.step()
        if state.ema is not None:
            state.ema.update(state.trainable, state.step,
                             decay=tcfg.ema_decay)
        state.step += 1
        return {**metrics, "grad_norm": gnorm}

    return step
