"""VBench-I2V generation harness.

Counterpart of open_pandora_tpu/eval/vbench.py (reference
tools/vbench.py:76-113): for each (image_name, prompt_en) of
vbench2_i2v_full_info.json, n_samples clips from the cropped image
through the ChatWM session, each written as an mp4 named by its prompt
for the external VBench scorer. The metadata list is cut to
[start_id:end_id], then shared out over the processes
(parallel.mesh.process_shard_indices; under torchrun, one card each);
sample s takes seed s.

Usage:
  python -m open_pandora_tpu_torch.eval.vbench --vbench-data DIR \\
      --save-dir OUT [--ckpt PATH] [--img-crop 8-5] [--ddim-steps 50]
      [--ugs 7.5] [--fs 8] [--n-samples 5] [--quantize-llm [int8|nf4]]
      [--debug] [--device cuda]

`run` is the core: metadata and uint8 images in, (file name, frames) out,
no file I/O. `main` reads the metadata (json) and the crops (PIL, through
pipeline/cli.decode_image) and writes the clips (OpenCV, through
ChatWM.save_video). `--debug` runs the tiny config of pipeline/cli.py
(pipeline/chat_wm.debug_world_config, 32x32 frames, at most 2 DDIM steps).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Iterator, List, Mapping, Tuple

import numpy as np

META_FILE = "vbench2_i2v_full_info.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vbench-i2v")
    p.add_argument("--vbench-data", required=True)
    p.add_argument("--save-dir", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--img-crop", default="8-5")
    p.add_argument("--ddim-steps", type=int, default=50)
    p.add_argument("--fs", type=int, default=8)
    p.add_argument("--n-samples", type=int, default=5)
    p.add_argument("--ugs", type=float, default=7.5)
    p.add_argument("--eta", type=float, default=1.0)
    p.add_argument("--start-id", type=int, default=0)
    p.add_argument("--end-id", type=int, default=int(1e9))
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", default="cuda")
    return p


def shard_items(items: List[dict], args) -> List[dict]:
    """The [start_id:end_id] slice of the metadata, then this process's
    share of it."""
    from open_pandora_tpu_torch.parallel.mesh import process_shard_indices

    items = items[args.start_id: args.end_id]
    return [items[i] for i in process_shard_indices(len(items))]


def clip_name(prompt: str, s: int, n_samples: int) -> str:
    return f"{prompt}-{s}.mp4" if n_samples > 1 else f"{prompt}.mp4"


def run(chat, items: List[dict], images: Mapping[str, np.ndarray], args
        ) -> Iterator[Tuple[str, np.ndarray]]:
    """(file name, uint8 frames (T, H, W, 3)) for each sample of this
    process's items; `images[image_name]` is the uint8 (H, W, 3) crop."""
    for m in shard_items(items, args):
        image = images[m["image_name"]]
        for s in range(args.n_samples):
            frames = chat.generate_video(
                image, m["prompt_en"], ddim_steps=args.ddim_steps,
                fs=args.fs, guidance_scale=args.ugs, eta=args.eta, seed=s)
            yield clip_name(m["prompt_en"], s, args.n_samples), frames


class _CropDir(dict):
    """image_name -> the decoded crop, read when asked for."""

    def __init__(self, root: str):
        super().__init__()
        self.root = root

    def __missing__(self, name: str) -> np.ndarray:
        from open_pandora_tpu_torch.pipeline.cli import decode_image

        return decode_image(os.path.join(self.root, name))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from open_pandora_tpu_torch.parallel.launch import (init_distributed,
                                                        local_device)
    from open_pandora_tpu_torch.pipeline.cli import build_chat

    device = local_device(args.device)
    init_distributed(device)
    args.device = str(device)
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.vbench_data, META_FILE)) as f:
        meta = json.load(f)
    shard = shard_items(meta, args)
    chat = build_chat(args)
    crops = _CropDir(os.path.join(args.vbench_data, "crop", args.img_crop))
    for i, (name, frames) in enumerate(run(chat, meta, crops, args), 1):
        chat.save_video(os.path.join(args.save_dir, name), frames, fps=8)
        if i % args.n_samples == 0:
            m = shard[i // args.n_samples - 1]
            print(f"[vbench] {m['image_name']}: {args.n_samples} samples",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
