"""ChatUniVi supervised-finetuning data.

This package's own copy of open_pandora_tpu/data/sft.py (reference
ChatUniVi/train/train.py:298-848: `preprocess_multimodal`, `preprocess_v1`,
`LazySupervisedDataset`, `DataCollatorForSupervisedDataset`, and
mm_utils.py:18 `tokenizer_image_token`). Each conversation is lowered to
the world model's segment layout (TokenSegment / ImageSegment /
VideoSegment) with per-token labels, padded per chunk column to the
batch's longest (and the last chunk to a bucket). Every padded chunk
carries a real-token mask: batches can mix chunk lengths, so pads can sit
mid-sequence and are masked out of attention and made position-
transparent (train/llm_step.sft_loss).

Image records read their files with PIL, video records theirs with
OpenCV (`utils/video_io.read_video_frames`, `max_frames` sampled
uniformly), each imported when a record needs it.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import random
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from open_pandora_tpu_torch.models.world_model import (ImageSegment,
                                                       MultimodalPrompt,
                                                       TokenSegment,
                                                       VideoSegment,
                                                       segment_length)
from open_pandora_tpu_torch.pipeline.conversation import (Conversation,
                                                          SeparatorStyle,
                                                          conv_templates)

log = logging.getLogger("open_pandora_tpu_torch.data.sft")

IGNORE_INDEX = -100
IMAGE_SENTINEL = -200          # ChatUniVi/constants.py IMAGE_TOKEN_INDEX
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
MAX_IMAGE_LENGTH = 64          # ChatUniVi/constants.py:7


def tokenize_with_images(prompt: str, tokenizer,
                         add_bos: bool = True) -> List[int]:
    """tokenizer_image_token: tokenize around the `<image>` splits and put
    IMAGE_SENTINEL at each boundary; BOS only on the first chunk."""
    chunks = [tokenizer.encode(c, add_bos=(add_bos and i == 0))
              for i, c in enumerate(prompt.split(DEFAULT_IMAGE_TOKEN))]
    ids: List[int] = []
    for i, c in enumerate(chunks):
        if i > 0:
            ids.append(IMAGE_SENTINEL)
        ids.extend(c)
    return ids


def preprocess_multimodal(sources: Sequence[List[Dict]],
                          max_image_length: int = MAX_IMAGE_LENGTH,
                          ) -> List[List[Dict]]:
    """train.py:298-336: move trailing image/video runs to the front, cap
    <image> runs at max_image_length, expand <video> to a
    max_image_length-frame image run."""
    out = []
    for source in sources:
        source = copy.deepcopy(list(source))
        for sentence in source:
            v = sentence["value"]
            for tok in (DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN):
                if v.endswith(tok):
                    n = v.count(tok)
                    v = v.replace("\n" + tok * n, "").strip()
                    v = (tok * n + "\n" + v).strip()
            n_img = v.count(DEFAULT_IMAGE_TOKEN)
            if n_img > max_image_length:
                v = v.replace(DEFAULT_IMAGE_TOKEN * n_img,
                              DEFAULT_IMAGE_TOKEN * max_image_length).strip()
            v = v.replace(DEFAULT_VIDEO_TOKEN,
                          DEFAULT_IMAGE_TOKEN * max_image_length)
            sentence["value"] = v
        out.append(source)
    return out


def preprocess_v1(source: List[Dict], tokenizer,
                  conv: Optional[Conversation] = None,
                  ) -> Tuple[List[int], List[int]]:
    """train.py:427-505 for one conversation: the vicuna TWO template,
    everything but the assistant replies masked to IGNORE_INDEX (a reply's
    closing </s> is supervised). Ids and labels are built from the
    template's pieces, whose concatenation is the rendered prompt, so they
    align for any tokenizer (the reference counts re-tokenized substrings
    and warns of mismatches, train.py:494-500)."""
    conv = (conv or conv_templates["v1"]).copy()
    assert conv.sep_style == SeparatorStyle.TWO
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    if roles.get(source[0]["from"]) != conv.roles[0]:
        source = source[1:]

    pieces: List[Tuple[str, bool]] = [(conv.system + conv.sep, False)]
    for j, sentence in enumerate(source):
        role = roles[sentence["from"]]
        assert role == conv.roles[j % 2], "conversation roles out of order"
        if j % 2 == 0:
            pieces.append((conv.roles[0] + ": " + sentence["value"]
                           + conv.sep, False))
            pieces.append((conv.roles[1] + ": ", False))
        else:
            pieces.append((sentence["value"] + conv.sep2, True))

    ids: List[int] = [tokenizer.bos_token_id]
    labels: List[int] = [IGNORE_INDEX]
    for text, supervised in pieces:
        part = tokenize_with_images(text, tokenizer, add_bos=False)
        ids.extend(part)
        labels.extend(t if supervised else IGNORE_INDEX for t in part)
    return ids, labels


def preprocess_plain(source: List[Dict], tokenizer,
                     ) -> Tuple[List[int], List[int]]:
    """train.py:575-592: caption pretraining pairs, '<image>' + caption,
    only the caption supervised."""
    assert len(source) == 2
    assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
    conv = conv_templates["plain"]
    text = DEFAULT_IMAGE_TOKEN + source[1]["value"] + conv.sep
    ids = tokenize_with_images(text, tokenizer)
    labels = list(ids)
    n_masked = len(tokenize_with_images(DEFAULT_IMAGE_TOKEN, tokenizer))
    labels[:n_masked] = [IGNORE_INDEX] * n_masked
    return ids, labels


def preprocess(source: List[Dict], tokenizer, template: str = "v1",
               ) -> Tuple[List[int], List[int]]:
    """train.py:595-641's dispatch (its live branches: plain, v1)."""
    if template == "plain":
        return preprocess_plain(source, tokenizer)
    if template.startswith("v1"):
        return preprocess_v1(source, tokenizer, conv_templates["v1"])
    raise ValueError(f"unsupported conversation template {template!r}")


# -- lowering -----------------------------------------------------------------

@dataclass
class SFTExample:
    """One conversation lowered to segments: per-TokenSegment ids and
    labels; between consecutive chunks one image (or one video, when a run
    of images is a video). `signature` is the layout, the batching key."""

    chunk_ids: List[List[int]]
    chunk_labels: List[List[int]]
    n_images: int
    images: Optional[np.ndarray]       # (n_images, S, S, 3) or None
    is_video: bool = False

    @property
    def signature(self) -> Tuple:
        return (len(self.chunk_ids), self.n_images, self.is_video)

    @property
    def n_text(self) -> int:
        return sum(len(c) for c in self.chunk_ids)


def lower_to_chunks(ids: List[int], labels: List[int],
                    ) -> Tuple[List[List[int]], List[List[int]], List[int]]:
    """Split sentinel-bearing id and label streams into text chunks; a run
    of consecutive sentinels is one boundary (the reference groups
    consecutive image tokens into one video splice, arch.py:261-307).
    Returns the chunks and each boundary's run length."""
    chunk_ids: List[List[int]] = [[]]
    chunk_labels: List[List[int]] = [[]]
    prev_sentinel = False
    runs = []
    run = 0
    for t, lab in zip(ids, labels):
        if t == IMAGE_SENTINEL:
            if not prev_sentinel:
                chunk_ids.append([])
                chunk_labels.append([])
                run = 0
            run += 1
            prev_sentinel = True
            continue
        if prev_sentinel:
            runs.append(run)
            prev_sentinel = False
        chunk_ids[-1].append(t)
        chunk_labels[-1].append(lab)
    if prev_sentinel:
        runs.append(run)
    return chunk_ids, chunk_labels, runs


def example_from_conversation(source: List[Dict], tokenizer,
                              images: Optional[np.ndarray] = None,
                              template: str = "v1") -> SFTExample:
    src = preprocess_multimodal([source])[0]
    ids, labels = preprocess(src, tokenizer, template)
    chunk_ids, chunk_labels, runs = lower_to_chunks(ids, labels)
    is_video = any(r > 1 for r in runs)
    n_images = images.shape[0] if images is not None else sum(
        1 if r == 1 else r for r in runs)
    return SFTExample(chunk_ids, chunk_labels, n_images=n_images,
                      images=images, is_video=is_video)


def collate_examples(examples: Sequence[SFTExample], cfg,
                     bucket: Optional[int] = None, pad_id: int = 0):
    """One batch of same-signature examples: {'prompt': MultimodalPrompt,
    'labels': (b, L) int64}, the labels full length (feature spans and
    pads IGNORE_INDEX). Each chunk column pads to its longest; `bucket`
    pads the last chunk so the text totals at least `bucket`."""
    sig = examples[0].signature
    assert all(e.signature == sig for e in examples), \
        "collate requires one layout signature per batch"
    n_chunks, n_images, is_video = sig
    b = len(examples)

    chunk_lens = [max(len(e.chunk_ids[c]) for e in examples)
                  for c in range(n_chunks)]
    if bucket is not None:
        total = sum(chunk_lens)
        if total < bucket:
            chunk_lens[-1] += bucket - total

    segments, label_cols, img_idx = [], [], 0
    for c in range(n_chunks):
        ids = np.full((b, chunk_lens[c]), pad_id, np.int64)
        lab = np.full((b, chunk_lens[c]), IGNORE_INDEX, np.int64)
        msk = np.zeros((b, chunk_lens[c]), bool)
        for i, e in enumerate(examples):
            n = len(e.chunk_ids[c])
            ids[i, :n] = e.chunk_ids[c]
            lab[i, :n] = e.chunk_labels[c]
            msk[i, :n] = True
        # masks on every chunk, pads or not: one layout per signature
        segments.append(TokenSegment(torch.from_numpy(ids),
                                     torch.from_numpy(msk)))
        label_cols.append(lab)
        if c < n_chunks - 1:
            if is_video:
                seg = VideoSegment(tuple(range(img_idx, img_idx + n_images)))
                img_idx += n_images
            else:
                seg = ImageSegment(img_idx)
                img_idx += 1
            segments.append(seg)
            label_cols.append(np.full((b, segment_length(cfg, seg)),
                                      IGNORE_INDEX, np.int64))

    if examples[0].images is not None:
        images = torch.from_numpy(np.stack([e.images for e in examples]))
    else:
        s = cfg.clip_tower.image_size
        images = torch.zeros((b, max(n_images, 1), s, s, 3))
    return {"prompt": MultimodalPrompt(segments=segments, images=images),
            "labels": torch.from_numpy(np.concatenate(label_cols, axis=1))}


def batch_rows(batch: Dict, lo: int, hi: int) -> Dict:
    """Rows [lo, hi) of a collated batch."""
    prompt = batch["prompt"]
    segments = [replace(seg, ids=seg.ids[lo:hi], mask=None if seg.mask is None
                        else seg.mask[lo:hi])
                if isinstance(seg, TokenSegment) else seg
                for seg in prompt.segments]
    return {"prompt": MultimodalPrompt(segments=segments,
                                       images=prompt.images[lo:hi]),
            "labels": batch["labels"][lo:hi]}


def synthetic_conversations(n: int = 32, seed: int = 0) -> List[Dict]:
    """Deterministic chat records, text-only and single-image in turns,
    for SFT runs without external data."""
    rng = random.Random(seed)
    subjects = ["a red car", "two dogs", "the mountain road", "a sailboat",
                "the city at night", "a field of flowers"]
    verbs = ["drives", "runs", "turns", "sails", "glows", "sways"]
    recs = []
    for i in range(n):
        s, v = rng.choice(subjects), rng.choice(verbs)
        q = f"describe what happens with {s}"
        a = f"{s} {v} slowly across the scene"
        conv = [{"from": "human",
                 "value": (f"<image>\n{q}" if i % 2 == 0 else q)},
                {"from": "gpt", "value": a}]
        recs.append({"conversations": conv})
    return recs


# -- dataset ------------------------------------------------------------------

class ConversationDataset:
    """Lazy JSON conversation dataset (train.py:644-797). Records:
    {"conversations": [{"from": "human"|"gpt", "value": ...}], optional
    "image": path (or list of paths) under `image_root`, optional "video":
    path under `video_root`}."""

    def __init__(self, chat_paths: Sequence[str], tokenizer,
                 image_root: Optional[str] = None,
                 video_root: Optional[str] = None,
                 clip_size: int = 224, template: str = "v1",
                 max_frames: int = MAX_IMAGE_LENGTH, seed: int = 0,
                 records: Optional[List[Dict]] = None):
        self.records: List[Dict] = list(records or [])
        for p in chat_paths:
            with open(p) as f:
                self.records.extend(json.load(f))
        random.Random(seed).shuffle(self.records)
        self.tokenizer = tokenizer
        self.image_root = image_root
        self.video_root = video_root
        self.clip_size = clip_size
        self.template = template
        self.max_frames = max_frames

    def __len__(self) -> int:
        return len(self.records)

    def _load_image(self, path: str) -> np.ndarray:
        from PIL import Image

        from open_pandora_tpu_torch.pipeline.preprocess import (
            clip_tower_preprocess)
        full = os.path.join(self.image_root or "", path.replace("\\", "/"))
        rgb = np.asarray(Image.open(full).convert("RGB"))
        return clip_tower_preprocess(rgb, self.clip_size).numpy()

    def __getitem__(self, i: int) -> SFTExample:
        rec = self.records[i % len(self.records)]
        images = None
        if "image" in rec:
            files = rec["image"] if isinstance(rec["image"], list) \
                else [rec["image"]]
            images = np.stack([self._load_image(f) for f in files])
        elif "video" in rec:
            from open_pandora_tpu_torch.pipeline.preprocess import (
                clip_tower_preprocess)
            from open_pandora_tpu_torch.utils.video_io import (
                read_video_frames)
            frames, _ = read_video_frames(
                os.path.join(self.video_root or "", rec["video"]),
                num_frames=self.max_frames)
            images = np.stack([clip_tower_preprocess(f, self.clip_size)
                               .numpy() for f in frames])
        return example_from_conversation(rec["conversations"],
                                         self.tokenizer, images=images,
                                         template=self.template)

    def batches(self, batch_size: int, cfg, bucket: Optional[int] = None,
                drop_remainder: bool = False,
                shard: Tuple[int, int] = (0, 1)):
        """Collated batches of one signature each; the leftover groups
        follow at the end unless drop_remainder. A record that fails to
        load is skipped (webvid.py:104 semantics). `batch_size` is the
        global batch; with `shard=(rank, n)` (which needs drop_remainder
        when n > 1) each is cut to this rank's rows [rank * b, (rank + 1)
        * b), b = batch_size / n, of the global collated batch (its
        lengths): every rank reads every record to know the groups."""
        rank, n = shard
        if batch_size % n:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{n} data ranks")
        if n > 1 and not drop_remainder:
            raise ValueError("sharded batches need drop_remainder: a "
                             "leftover group does not split evenly")
        b = batch_size // n
        groups: Dict[Tuple, List[SFTExample]] = {}
        for i in range(len(self)):
            try:
                ex = self[i]
            except Exception as e:  # noqa: BLE001
                log.warning("skipping sample %d: %s", i, e)
                continue
            g = groups.setdefault(ex.signature, [])
            g.append(ex)
            if len(g) == batch_size:
                batch = collate_examples(g, cfg, bucket=bucket)
                yield batch if n == 1 else batch_rows(
                    batch, rank * b, (rank + 1) * b)
                groups[ex.signature] = []
        if not drop_remainder:
            for g in groups.values():
                if g:
                    yield collate_examples(g, cfg, bucket=bucket)
