"""Video consistency runner: two questions answered over the same frames.

Counterpart of open_pandora_tpu/eval/consistency.py (reference
ChatUniVi/eval/model_video_consistency.py): for each sample {video_name,
Q1, Q2, A} find the video under --video-folder (.mp4, .avi, .mov, .mkv
in that order), decode up to --max-frames frames, answer both questions
independently over them and write {video_name, prompt_1, text_1,
prompt_2, text_2, answer_id, model_id, answer, metadata}, the record the
consistency judge reads.

`answer_sample` is the I/O-free core (uint8 frames in, a record out);
`main` decodes the videos through `utils.video_io` (OpenCV, imported
then). Sampling as in eval/scienceqa.py.

Usage:
  python -m open_pandora_tpu_torch.eval.consistency --questions q.json \\
      --video-folder DIR --out answers.jsonl [--ckpt ...] [--debug]
      [--device cuda] [--quantize-llm [int8|nf4]]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

VIDEO_FORMATS = (".mp4", ".avi", ".mov", ".mkv")


def find_video(folder: str, name: str):
    """The first extension that exists, else None."""
    for fmt in VIDEO_FORMATS:
        path = os.path.join(folder, f"{name}{fmt}")
        if os.path.exists(path):
            return path
    return None


def build_parser():
    from open_pandora_tpu_torch.eval.chatunivi_qa import add_model_args

    p = argparse.ArgumentParser("video-consistency")
    p.add_argument("--questions", required=True)
    p.add_argument("--video-folder", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--conv-mode", default="v1")
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--max-frames", type=int, default=16,
                   help="frame budget (reference MAX_IMAGE_LENGTH=64)")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--debug", action="store_true")
    add_model_args(p)
    return p


def answer_sample(wm, tok, sample: dict, frames: np.ndarray, index: int, *,
                  conv_mode: str = "v1", max_new_tokens: int = 64,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> dict:
    """Both questions of `sample` over its uint8 frames (T, H, W, 3); the
    record's answer_id is `vc-{index}`."""
    from open_pandora_tpu_torch.eval.chatunivi_qa import (
        generate_text, segments_from_prompt, strip_stop, tower_images)
    from open_pandora_tpu_torch.pipeline.conversation import (SeparatorStyle,
                                                              conv_templates)

    images = tower_images(wm, frames)
    n_img = images.shape[1]

    def answer(question: str) -> str:
        conv = conv_templates[conv_mode].copy()
        conv.append_message(conv.roles[0], "<image>" * n_img + "\n" + question)
        conv.append_message(conv.roles[1], None)
        stop_str = (conv.sep if conv.sep_style != SeparatorStyle.TWO
                    else conv.sep2)
        segs = segments_from_prompt(tok, conv.get_prompt(), n_img)
        return strip_stop(generate_text(wm, tok, segs, images, max_new_tokens,
                                        temperature, generator), stop_str)

    return {"video_name": sample["video_name"],
            "prompt_1": sample["Q1"], "text_1": answer(sample["Q1"]),
            "prompt_2": sample["Q2"], "text_2": answer(sample["Q2"]),
            "answer_id": f"vc-{index}", "model_id": "open-pandora-tpu",
            "answer": sample["A"], "metadata": {}}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from open_pandora_tpu_torch.eval.chatunivi_qa import (get_chunk,
                                                          setup_model)
    from open_pandora_tpu_torch.utils.video_io import read_video_frames

    wm, tok, _, _ = setup_model(args.ckpt, args.tokenizer, args.debug,
                                args.device, args.quantize_llm)
    max_new = 4 if args.debug else args.max_new_tokens
    with open(os.path.expanduser(args.questions)) as f:
        samples = json.load(f)
    samples = get_chunk(samples, args.num_chunks, args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    generator = torch.Generator(device=wm.device).manual_seed(args.seed)
    with open(os.path.expanduser(args.out), "w") as fout:
        for i, sample in enumerate(samples):
            name = sample["video_name"]
            path = find_video(args.video_folder, name)
            if path is None:
                print(f"[consistency] missing video: {name}", flush=True)
                continue
            frames, _ = read_video_frames(path, num_frames=args.max_frames)
            rec = answer_sample(wm, tok, sample, frames, i,
                                conv_mode=args.conv_mode,
                                max_new_tokens=max_new,
                                temperature=args.temperature,
                                generator=generator)
            fout.write(json.dumps(rec) + "\n")
            fout.flush()
    print(f"[consistency] wrote answers -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
