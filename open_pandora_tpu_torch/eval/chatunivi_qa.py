"""ChatUniVi QA runner: image and video questions answered by greedy
decoding.

Counterpart of open_pandora_tpu/eval/chatunivi_qa.py (reference
ChatUniVi/eval/model_video_qa.py and the model_vqa* variants): read a
json/jsonl question set, take this worker's chunk, answer each question
over its image or video frames, write {id, question, answer} lines. It
also holds the pieces the other runners share (eval/scienceqa.py,
eval/consistency.py): `setup_model`, `segments_from_prompt`, `decode_ids`,
`strip_stop`, `get_chunk`.

`answer_question` is the I/O-free core: a question and its media as uint8
arrays in, a record out. `main` adds the files: images through
`pipeline.cli.decode_image` (PIL) and videos through `utils.video_io`
(OpenCV), each imported when a file is read.

Usage:
  python -m open_pandora_tpu_torch.eval.chatunivi_qa --questions q.jsonl \\
      --media-dir DIR --out answers.jsonl [--ckpt ...] [--tokenizer ...]
      [--num-chunks N --chunk-idx I] [--max-new-tokens 64] [--debug]
      [--device cuda] [--quantize-llm [int8|nf4]]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import List, Optional

import numpy as np
import torch


def get_chunk(items, num_chunks: int, idx: int):
    """model_video_qa.py's contiguous split."""
    size = math.ceil(len(items) / num_chunks)
    return items[idx * size: (idx + 1) * size]


def load_questions(path: str):
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(ln) for ln in f if ln.strip()]
        return json.load(f)


def add_model_args(p: argparse.ArgumentParser) -> None:
    """The options every runner adds to the JAX parser's: the device and
    the LLaMA's weight-only quantization."""
    p.add_argument("--device", default="cuda")
    p.add_argument("--quantize-llm", nargs="?", const="int8",
                   choices=["int8", "nf4"], default=False,
                   help="weight-only LLaMA quantization (int8 or nf4)")


def build_parser():
    p = argparse.ArgumentParser("chatunivi-qa")
    p.add_argument("--questions", required=True)
    p.add_argument("--media-dir", default=".")
    p.add_argument("--out", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--tokenizer", default=None)
    p.add_argument("--num-chunks", type=int, default=1)
    p.add_argument("--chunk-idx", type=int, default=0)
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--video-frames", type=int, default=16)
    p.add_argument("--debug", action="store_true")
    add_model_args(p)
    return p


def setup_model(ckpt=None, tokenizer=None, debug: bool = False,
                device="cuda", quantize_llm=False):
    """(WorldModel, tokenizer, height, width), shared by every runner:
    the CLI's build (pipeline/cli.build_world): `debug` is the port's tiny
    config (pipeline/chat_wm.debug_world_config), else PandoraConfig() in
    bf16; random weights without `ckpt`."""
    from open_pandora_tpu_torch.pipeline.cli import build_world
    from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer

    args = argparse.Namespace(ckpt=ckpt, debug=debug, device=device,
                              quantize_llm=quantize_llm)
    wm, height, width = build_world(args)
    return wm, load_tokenizer(tokenizer), height, width


def decode_ids(tok, out_ids) -> str:
    """A (n,) id row from greedy_generate as text, specials skipped (the
    hash tokenizer, which has no decoder: the ids joined by spaces)."""
    ids_list = [int(i) for i in np.asarray(torch.as_tensor(out_ids).cpu())]
    if hasattr(tok, "tok"):
        return tok.tok.decode(ids_list, skip_special_tokens=True)
    return " ".join(str(i) for i in ids_list)


def _ids(ids: List[int]) -> torch.Tensor:
    return torch.tensor([ids], dtype=torch.int64)


def segments_from_prompt(tok, prompt: str, n_images: int = 0):
    """A rendered conversation prompt split on '<image>' into Token, Image
    and Video segments (mm_utils.tokenizer_image_token: the text chunks
    tokenized apart, one media slot per sentinel; the first chunk with
    bos). A run of sentinels is one VideoSegment over those images, a
    single one an ImageSegment."""
    from open_pandora_tpu_torch.models.world_model import (ImageSegment,
                                                           TokenSegment,
                                                           VideoSegment)

    def media(used: int, pending: int):
        return (ImageSegment(used) if pending == 1 else
                VideoSegment(tuple(range(used, used + pending))))

    parts = prompt.split("<image>")
    segs = [TokenSegment(_ids(tok.encode(parts[0], add_bos=True)))]
    used = pending = 0
    for piece in parts[1:]:
        pending += 1
        if piece == "":
            continue
        segs.append(media(used, pending))
        used, pending = used + pending, 0
        ids = tok.encode(piece, add_bos=False)
        if ids:
            segs.append(TokenSegment(_ids(ids)))
    if pending:
        segs.append(media(used, pending))
        used += pending
    if used != n_images:
        raise ValueError(f"prompt has {used} media slots, got {n_images} "
                         "images")
    return segs


def strip_stop(text: str, stop_str: str) -> str:
    """model_video_qa.py's tail: cut at the separator, strip."""
    if stop_str and stop_str in text:
        text = text.split(stop_str)[0]
    text = text.strip()
    if stop_str and text.endswith(stop_str):
        text = text[: -len(stop_str)]
    return text.strip()


def tower_images(wm, media: Optional[np.ndarray]) -> Optional[torch.Tensor]:
    """uint8 (H, W, 3) image or (T, H, W, 3) frames -> the prompt's CLIP
    tower stack (1, n, size, size, 3) on the model's device; None for no
    media."""
    from open_pandora_tpu_torch.pipeline.preprocess import (
        clip_tower_preprocess)

    if media is None:
        return None
    frames = media if media.ndim == 4 else media[None]
    return clip_tower_preprocess(frames, wm.cfg.clip_tower.image_size,
                                 wm.device)[None]


def generate_text(wm, tok, segments, images, max_new_tokens: int,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None) -> str:
    """Decode the answer to a prompt of segments over `images`."""
    from open_pandora_tpu_torch.models.llama_generate import greedy_generate
    from open_pandora_tpu_torch.models.world_model import MultimodalPrompt

    with torch.no_grad():
        embeds, _ = wm.build_inputs_embeds(
            MultimodalPrompt(segments=segments, images=images))
        out = greedy_generate(wm.llama, embeds, max_new_tokens=max_new_tokens,
                              temperature=temperature, generator=generator)
    return decode_ids(tok, out[0])


def answer_question(wm, tok, q: dict, media: Optional[np.ndarray] = None,
                    max_new_tokens: int = 64) -> dict:
    """One question (its "text" or "question") over `media`: None, an
    image (H, W, 3) or video frames (T, H, W, 3), uint8. The prompt is
    bos, the media, the text; the record {id, question, answer}."""
    from open_pandora_tpu_torch.models.world_model import (ImageSegment,
                                                           TokenSegment,
                                                           VideoSegment)

    text = q.get("text") or q.get("question") or ""
    ids = _ids(tok.encode(text, add_bos=True))
    images = tower_images(wm, media)
    segments = [TokenSegment(ids[:, :1])]
    if images is not None:
        n = images.shape[1]
        segments.append(VideoSegment(tuple(range(n))) if media.ndim == 4
                        else ImageSegment(0))
    segments.append(TokenSegment(ids[:, 1:]))
    return {"id": q.get("id") or q.get("question_id"), "question": text,
            "answer": generate_text(wm, tok, segments, images,
                                    max_new_tokens)}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from open_pandora_tpu_torch.pipeline.cli import decode_image
    from open_pandora_tpu_torch.utils.video_io import read_video_frames

    if args.debug:
        args.max_new_tokens = min(args.max_new_tokens, 4)
    wm, tok, _, _ = setup_model(args.ckpt, args.tokenizer, args.debug,
                                args.device, args.quantize_llm)
    questions = get_chunk(load_questions(args.questions), args.num_chunks,
                          args.chunk_idx)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fout:
        for q in questions:
            media = None
            if q.get("video"):
                media, _ = read_video_frames(
                    os.path.join(args.media_dir, q["video"]),
                    num_frames=args.video_frames)
            elif q.get("image"):
                media = decode_image(os.path.join(args.media_dir,
                                                  q["image"]))
            rec = answer_question(wm, tok, q, media, args.max_new_tokens)
            fout.write(json.dumps(rec) + "\n")
            fout.flush()
    print(f"[qa] wrote {len(questions)} answers -> {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
