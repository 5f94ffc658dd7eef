"""Command line: one image and one action per round -> an mp4.

Counterpart of open_pandora_tpu/pipeline/cli.py (the reference's
gradio_app.py), with the same options and defaults, plus `--device`:

  python -m open_pandora_tpu_torch.pipeline.cli --image car.png \\
      --action "the car moves forward" --action "the car turns left" \\
      --out out.mp4 [--ddim-steps 50 --ugs 4.0 --eta 1.0 --fs 15 --seed 123]
      [--ckpt step_<n>/ or model.ckpt] [--tokenizer DIR]
      [--height 320 --width 512] [--debug] [--device cuda]

Without `--ckpt` the weights are random (seeded 0); with it, a reference
checkpoint of the composite (a torch `.bin` / `.pt` / `.ckpt` or a
`.safetensors` file, or a directory of HF shards of either; PL or
DeepSpeed wrappers and renamed keys normalised, then loaded strictly), or
a `step_<n>` directory of the port's trainer, whose parameters are loaded
over those random weights (`load_weights`).
`--debug` runs the tiny config (pipeline/chat_wm.debug_world_config, fp32,
32x32 frames, at most 2 DDIM steps) on the same code path. Reading the
image needs PIL and writing the mp4 OpenCV, each imported then: `run`,
the rounds themselves, takes and returns NumPy arrays and needs neither.
`--quantize-llm [int8|nf4]` quantizes the LLaMA's projections weight-only
(models/quant.py) once the weights exist, after `--ckpt` is loaded or the
random weights drawn. The JAX package's quantized random init is codes 0
and scales 1, every projection 0; here the random float LLaMA is
quantized, so the numbers stay non-degenerate.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("open-pandora-torch")
    p.add_argument("--image", required=True, help="conditioning image")
    p.add_argument("--action", action="append", required=True,
                   help="per-round action text (repeat for multi-round)")
    p.add_argument("--out", default="output.mp4")
    p.add_argument("--ckpt", default=None,
                   help="reference checkpoint (torch or .safetensors file, "
                        "HF shard directory), or a trainer step_<n> "
                        "directory")
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--ugs", type=float, default=4.0, help="guidance scale")
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--fs", type=int, default=15)
    p.add_argument("--fps", type=int, default=8, help="output fps")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False,
                   help="weight-only LLaMA quantization (int8 or nf4)")
    p.add_argument("--debug", action="store_true",
                   help="tiny config + random weights smoke mode")
    p.add_argument("--device", default="cuda")
    return p


def load_weights(wm, path: str) -> None:
    """`--ckpt`, as JAX `load_params` picks the path: a trainer `step_<n>`
    directory (its parameters over the model's current ones), else a
    reference checkpoint of the composite through
    core.checkpoint.load_torch_flat (a torch or `.safetensors` file, or a
    directory of HF shards), normalised and loaded strictly. A `step_<n>`
    directory is told from a shard directory by the `params.pt` the
    trainer writes into it (core.checkpoint.PARAMS_FILE): a shard
    directory holds no file of that name."""
    from open_pandora_tpu_torch.core.checkpoint import (PARAMS_FILE,
                                                        restore_params)
    from open_pandora_tpu_torch.eval.inference import load_checkpoint

    if os.path.isfile(os.path.join(path, PARAMS_FILE)):
        restore_params(path, wm.state_dict(), strict=False)
    else:
        load_checkpoint(wm, path)


def build_world(args):
    """(WorldModel, height, width) of parsed arguments: `debug`, `device`,
    `ckpt`, `quantize_llm`, and where the parser has them `height`,
    `width` and `bf16` (shared with pipeline/server.py and the eval
    runners)."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.models.quant import quantize_llama_
    from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                         debug_world_config)

    device = torch.device(args.device)
    if args.debug:
        cfg, dtype, (height, width) = (debug_world_config(), torch.float32,
                                       (32, 32))
    else:
        cfg = PandoraConfig()
        height, width = getattr(args, "height", 320), getattr(args, "width",
                                                               512)
        dtype = (torch.bfloat16 if getattr(args, "bf16", True)
                 else torch.float32)
    quantize = getattr(args, "quantize_llm", False)
    print(f"[cli] building WorldModel ({'debug-tiny' if args.debug else 'full'}"
          f", {dtype}, {device}"
          f"{f', LLaMA {quantize}' if quantize else ''})", flush=True)
    wm = build_world_model(cfg, device=device, dtype=dtype,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))
    if args.ckpt:
        load_weights(wm, args.ckpt)
    else:
        print("[cli] NO CHECKPOINT: random weights (smoke mode)", flush=True)
    quantize_llama_(wm.llama, quantize)
    return wm, height, width


def build_chat(args):
    """The ChatWM session of parsed CLI arguments (shared with
    pipeline/server.py)."""
    from open_pandora_tpu_torch.pipeline.chat_wm import ChatWM
    from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer

    wm, height, width = build_world(args)
    if args.debug:
        args.ddim_steps = min(args.ddim_steps, 2)
    return ChatWM(wm, tokenizer=load_tokenizer(args.tokenizer),
                  height=height, width=width)


def decode_image(src) -> np.ndarray:
    """An image file (path or file object) -> uint8 RGB (H, W, 3), as the
    JAX session reads it (PIL, `.convert("RGB")`)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading an image file needs PIL (the pillow "
                          "package), which is not installed") from e
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"))


def run(chat, image: np.ndarray, args) -> np.ndarray:
    """The session's rounds, one per action, on a uint8 (H, W, 3) image:
    uint8 frames (T, H, W, 3), overlaps trimmed."""
    return chat.generate_video_multiround(
        image, list(args.action), ddim_steps=args.ddim_steps,
        guidance_scale=args.ugs, eta=args.eta, fs=args.fs, seed=args.seed)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    chat = build_chat(args)
    frames = run(chat, decode_image(args.image), args)
    path = chat.save_video(args.out, frames, fps=args.fps)
    print(f"[cli] wrote {path}: {frames.shape[0]} frames "
          f"{frames.shape[2]}x{frames.shape[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
