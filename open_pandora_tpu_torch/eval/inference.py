"""DynamiCrafter image-to-video inference over a prompt directory.

Counterpart of open_pandora_tpu/eval/inference.py, with the same CLI. The
work is split in two: `synthesize` takes a NumPy image and a prompt and
returns NumPy frames (no file IO, no PIL or OpenCV), and `main` does the
file IO around it.

Usage:
  python -m open_pandora_tpu_torch.eval.inference --prompt-dir DIR \
      --save-dir OUT [--ckpt PATH] [--bpe MERGES] [--ddim-steps 50]
      [--ugs 7.5] [--guidance-rescale 0.7] [--height 320 --width 512]
      [--fs 3] [--device cuda] [--debug]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from open_pandora_tpu_torch.core.config import (CLIPTextConfig,
                                                CLIPVisionConfig,
                                                PandoraConfig,
                                                ResamplerConfig,
                                                UNet3DConfig, VAEConfig)
from open_pandora_tpu_torch.core.init import init_random_
from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer


def debug_config(t: int = 4) -> PandoraConfig:
    """The tiny configuration of the --debug smoke run (32x32 frames)."""
    return PandoraConfig(
        vae=VAEConfig(base_channels=32, channel_mult=(1, 2),
                      num_res_blocks=1),
        unet=UNet3DConfig(
            in_channels=8, out_channels=4, model_channels=64,
            channel_mult=(1, 2), num_res_blocks=1, attention_resolutions=(1,),
            num_head_channels=32, context_dim=64, temporal_length=t,
            text_context_len=7, img_tokens_per_frame=2, dropout=0.0),
        clip_text=CLIPTextConfig(width=64, layers=2, heads=2,
                                 context_length=7),
        clip_vision=CLIPVisionConfig(image_size=28, patch_size=14, width=64,
                                     layers=2, heads=2),
        resampler=ResamplerConfig(dim=64, depth=1, dim_head=16, heads=2,
                                  num_queries=2, embedding_dim=64,
                                  output_dim=64, video_length=t))


def build_model(cfg: PandoraConfig, *, device, dtype=torch.float32,
                generator: Optional[torch.Generator] = None) -> DynamiCrafter:
    """DynamiCrafter allocated on `device` in `dtype`; random weights from
    `generator` (on `device`) when given, else uninitialised storage for a
    checkpoint to fill."""
    with torch.device("meta"):
        model = DynamiCrafter(cfg)
    model = model.to(dtype=dtype).to_empty(device=device).eval()
    if generator is not None:
        init_random_(model, generator)
    return model


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """(h, w, 3) -> size, bilinear with antialiasing."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=size, mode="bilinear",
                      align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def diffusion_preprocess(image: torch.Tensor, hw) -> torch.Tensor:
    """(H0, W0, 3) in [0, 1] -> (h, w, 3) in [-1, 1]: shortest side resized
    to min(h, w), scaled up again if the crop box is not covered, center
    crop (pipeline/preprocess.py's diffusion_preprocess)."""
    h, w = hw
    ih, iw = image.shape[:2]
    target = min(h, w)
    if iw < ih:
        size = (round(ih * target / iw), target)
    else:
        size = (target, round(iw * target / ih))
    x = _resize(image, size)
    if x.shape[0] < h or x.shape[1] < w:
        scale = max(h / x.shape[0], w / x.shape[1])
        x = _resize(x, (round(x.shape[0] * scale), round(x.shape[1] * scale)))
    top = max((x.shape[0] - h) // 2, 0)
    left = max((x.shape[1] - w) // 2, 0)
    return x[top:top + h, left:left + w] * 2.0 - 1.0


def synthesize(model: DynamiCrafter, image: np.ndarray, prompt: str, *,
               height: int = 320, width: int = 512, ddim_steps: int = 50,
               guidance_scale: float = 7.5, guidance_rescale: float = 0.7,
               eta: float = 1.0, fs: int = 3, cfg_img: Optional[float] = None,
               generator: torch.Generator,
               tokenizer: Optional[Callable] = None,
               timings: Optional[dict] = None) -> np.ndarray:
    """image (H0, W0, 3), uint8 or float in [0, 1] -> frames
    (1, T, height, width, 3) float32 in [-1, 1].

    `generator` (on the model's device) draws x_T and the DDIM noise. If a
    `timings` dict is given, the device is synchronised between phases and
    it receives conditioning_s, sampling_s, step_s and decode_s."""
    dev = model.device
    tokenizer = tokenizer or load_clip_tokenizer()
    img = torch.tensor(np.asarray(image), device=dev)
    img = img.float() / 255.0 if img.dtype == torch.uint8 else img.float()

    def mark():
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    with torch.no_grad():
        t0 = mark()
        ctx_len = model.cfg.clip_text.context_length
        tokens = torch.tensor([tokenizer(prompt, ctx_len)], device=dev)
        streams = model.synthesis_streams(
            text_context=model.encode_text(tokens), cond_images=img[None],
            cond_frames=diffusion_preprocess(img, (height, width))[None, None],
            guidance_scale=guidance_scale, cfg_img=cfg_img, fs=fs)
        t1 = mark()
        z = model.sample(streams, ddim_steps=ddim_steps,
                         guidance_scale=guidance_scale, eta=eta,
                         guidance_rescale=guidance_rescale, cfg_img=cfg_img,
                         generator=generator)
        t2 = mark()
        chunk = 8 if (height * width <= 320 * 512
                      and z.shape[1] % 8 == 0) else 1
        video = model.decode(z, frame_chunk=chunk).clamp(-1.0, 1.0)
        t3 = mark()
    if timings is not None:
        timings.update(conditioning_s=t1 - t0, sampling_s=t2 - t1,
                       step_s=(t2 - t1) / ddim_steps, decode_s=t3 - t2)
    return video.float().cpu().numpy()


def load_checkpoint(model: DynamiCrafter, path: str) -> None:
    """Load a reference DynamiCrafter checkpoint (plain, PL or DeepSpeed
    state dict). Keys the model does not hold (schedule buffers, unused
    open_clip parameters) are skipped; a key the model holds but the file
    lacks is an error."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    for wrapper in ("state_dict", "module"):
        if isinstance(raw.get(wrapper), dict):
            raw = raw[wrapper]
    sd = {}
    for k, v in raw.items():
        k = k.removeprefix("_forward_module.").replace("framestride_embed",
                                                       "fps_embedding")
        sd[k] = v
    wanted = model.state_dict().keys()
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError(f"{path}: {len(missing)} keys missing, e.g. "
                       f"{missing[:3]}")
    model.load_state_dict({k: sd[k] for k in wanted}, strict=True)


def load_prompt_list(prompt_dir: str):
    """Images in `prompt_dir` paired by order with the lines of its first
    .txt file; an image's own name (underscores as spaces) stands in for a
    missing prompt list or one with fewer lines than images."""
    exts = (".png", ".jpg", ".jpeg", ".webp", ".bmp")
    images = sorted(f for f in os.listdir(prompt_dir)
                    if f.lower().endswith(exts))
    prompts = [os.path.splitext(f)[0].replace("_", " ") for f in images]
    txts = [f for f in os.listdir(prompt_dir) if f.endswith(".txt")]
    if txts:
        with open(os.path.join(prompt_dir, txts[0])) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        if len(lines) >= len(images):
            prompts = lines[: len(images)]
    return list(zip(images, prompts))


def build_parser():
    p = argparse.ArgumentParser("dynamicrafter-inference")
    p.add_argument("--prompt-dir", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--bpe", default=None,
                   help="OpenCLIP BPE merges file; hash fallback without it")
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--ugs", type=float, default=7.5)
    p.add_argument("--guidance-rescale", type=float, default=0.7)
    p.add_argument("--cfg-img", type=float, default=None,
                   help="3-way CFG image guidance")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--fs", type=int, default=3, help="frame stride cond")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--n-samples", type=int, default=1)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--save-fps", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--debug", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from PIL import Image

    from open_pandora_tpu.utils.video_io import frames_to_uint8, write_video

    device = torch.device(args.device)
    if args.debug:
        cfg, dtype = debug_config(), torch.float32
        height = width = 32
        args.ddim_steps = min(args.ddim_steps, 2)
    else:
        cfg, dtype = PandoraConfig(), torch.bfloat16
        height, width = args.height, args.width
    if args.ckpt:
        model = build_model(cfg, device=device, dtype=dtype)
        load_checkpoint(model, args.ckpt)
    else:
        print("[inference] NO CHECKPOINT — random weights (smoke mode)",
              flush=True)
        model = build_model(
            cfg, device=device, dtype=dtype,
            generator=torch.Generator(device=device).manual_seed(0))
    tokenizer = load_clip_tokenizer(args.bpe)

    items = load_prompt_list(args.prompt_dir)
    os.makedirs(args.save_dir, exist_ok=True)
    t0 = time.time()
    for img_name, prompt in items:
        with Image.open(os.path.join(args.prompt_dir, img_name)) as im:
            image = np.asarray(im.convert("RGB"))
        for s in range(args.n_samples):
            video = synthesize(
                model, image, prompt, height=height, width=width,
                ddim_steps=args.ddim_steps, guidance_scale=args.ugs,
                guidance_rescale=args.guidance_rescale, eta=args.eta,
                fs=args.fs, cfg_img=args.cfg_img, tokenizer=tokenizer,
                generator=torch.Generator(device=device).manual_seed(
                    args.seed + s))
            name = os.path.splitext(img_name)[0]
            suffix = f"_{s}" if args.n_samples > 1 else ""
            write_video(os.path.join(args.save_dir, f"{name}{suffix}.mp4"),
                        frames_to_uint8(video[0]), fps=args.save_fps)
        print(f"[inference] {img_name} done", flush=True)
    print(f"[inference] total {time.time() - t0:.1f}s for {len(items)} "
          "prompts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
