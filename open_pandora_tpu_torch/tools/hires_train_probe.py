"""High-resolution training probe: the latent finetune step at 576x1024x16f
(BASELINE.md config 3's resolution) with gradient checkpointing.

Counterpart of open_pandora_tpu/tools/hires_train_probe.py. Only the UNet
trains, so the frozen encoders run once, before the step
(train/step.make_latent_finetune_step), and stay out of its memory:

  precompute  VAE-encode one synthetic clip, the CLIP text context of the
              empty prompt, the CLIP image / Resampler context of its
              first frame and the conditioning latents z_cond; saved as
              .npz (fp32)
  train       the latent step over those, `--steps` steps after a first
              one, the encoders dropped to the meta device; one JSON
              line: seconds per step, the first step, the losses, and on
              a card the peak device memory
  both        precompute, then train, in this process (the precompute
              model is freed before the step's model is built)

The JAX tool's --offload and --split paths are not ported: they work
round the TPU runtime's missing buffer donation.

Usage: python -m open_pandora_tpu_torch.tools.hires_train_probe
       [--phase precompute|train|both] [--latents PATH] [--steps 3]
       [--height 576 --width 1024] [--optimizer adamw|adamw8bit]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from open_pandora_tpu_torch.core.config import PandoraConfig


def precompute(cfg: PandoraConfig, device, *, height: int, width: int,
               path: str, dtype=torch.bfloat16) -> str:
    """The frozen encoders' work for one synthetic clip -> `path` (.npz of
    z, ctx, z_cond)."""
    from open_pandora_tpu_torch.eval.inference import build_model
    from open_pandora_tpu_torch.models.encoders import empty_prompt_tokens
    from open_pandora_tpu_torch.models.vae import encode_video

    device = torch.device(device)
    model = build_model(cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device)
                        .manual_seed(0))
    t = cfg.unet.temporal_length
    gen = torch.Generator(device=device).manual_seed(1)
    video = (torch.rand((1, t, height, width, 3), generator=gen,
                        device=device) * 2 - 1).to(dtype)
    with torch.no_grad():
        z = encode_video(model.first_stage_model, video,
                         scale_factor=cfg.diffusion.scale_factor,
                         generator=torch.Generator(device=device)
                         .manual_seed(2))
        text_ctx = model.encode_text(empty_prompt_tokens(
            1, cfg.clip_text.context_length, device=device))
        img_ctx = model.encode_image_context((video[:, 0] + 1) / 2)
        z_cond = model.get_latent_z(video[:, :1])
    np.savez(path, z=z.float().cpu().numpy(),
             ctx=torch.cat([text_ctx, img_ctx], dim=1).float().cpu().numpy(),
             z_cond=z_cond.float().cpu().numpy())
    del model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[precompute] wrote {path}", flush=True)
    return path


def train(cfg: PandoraConfig, device, *, latents: str, steps: int = 3,
          optimizer: str = "adamw8bit", dtype=torch.bfloat16) -> dict:
    """`steps` latent finetune steps after a first one; the report."""
    from open_pandora_tpu_torch.core.config import TrainConfig
    from open_pandora_tpu_torch.eval.inference import build_model
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_latent_finetune_step)

    if not cfg.unet.use_checkpoint:
        raise ValueError("the hi-res step needs the UNet's gradient "
                         "checkpointing (unet.use_checkpoint)")
    device = torch.device(device)
    data = np.load(latents)
    batch = {k: torch.from_numpy(data[k]).to(device, dtype)
             for k in ("z", "ctx", "z_cond")}
    batch["fps"] = torch.full((1,), 8, dtype=torch.int64, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device)
                        .manual_seed(0))
    for frozen in (model.first_stage_model, model.cond_stage_model,
                   model.embedder):
        frozen.to("meta")
    tcfg = TrainConfig(learning_rate=5e-5, uncond_prob=0.0, max_steps=10,
                       grad_clip_norm=0.5, optimizer=optimizer)
    state = TrainState.create(model, "dynamicrafter", tcfg)
    step = make_latent_finetune_step(model, tcfg)
    gen = torch.Generator(device=device).manual_seed(3)
    # float() of the loss waits for the step: the clock reads the device
    t0 = time.perf_counter()
    loss0 = float(step(state, batch, generator=gen)["loss"])
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(steps):
        m = step(state, batch, generator=gen)
    loss = float(m["loss"])
    per_step = (time.perf_counter() - t0) / steps
    _, t, hz, wz, _ = batch["z"].shape
    f = 2 ** (len(cfg.vae.channel_mult) - 1)
    rep = {"metric": f"latent_finetune_step_{hz * f}x{wz * f}x{t}f_bs1",
           "optimizer": optimizer, "sec_per_step": per_step,
           "first_step_s": first, "loss_first": loss0, "loss_last": loss,
           "device": str(device)}
    if device.type == "cuda":
        rep["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        rep["now_bytes"] = torch.cuda.memory_allocated(device)
    del state, model, step
    return rep


def main(argv=None) -> int:
    p = argparse.ArgumentParser("hires-train-probe")
    p.add_argument("--height", type=int, default=576)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--latents", default=os.path.join(tempfile.gettempdir(),
                                                     "hires_latents.npz"))
    p.add_argument("--phase", choices=["precompute", "train", "both"],
                   default="both")
    p.add_argument("--optimizer", default="adamw8bit",
                   choices=["adamw", "adamw8bit"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = PandoraConfig()
    if args.phase in ("precompute", "both"):
        precompute(cfg, args.device, height=args.height, width=args.width,
                   path=args.latents)
    if args.phase in ("train", "both"):
        print(json.dumps(train(cfg, args.device, latents=args.latents,
                               steps=args.steps, optimizer=args.optimizer)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
