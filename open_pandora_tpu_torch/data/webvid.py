"""Training data: the WebVid dataset, the synthetic video dataset and the
batching loader.

Counterpart of open_pandora_tpu/data/webvid.py (reference data/webvid.py),
with the same sample and batch contract (train/step.py) and the same
seeds:
  - `WebVidDataset`: CSV metadata (videoid, page_dir, name -> caption),
    clips under data_dir/videos/<page_dir>/<videoid>.mp4; a random frame
    stride in [frame_stride_min, frame_stride] with `random_fs`, scaled by
    fps / fixed_fps with `fixed_fps`; clips that fail to open or are too
    short are skipped (the next index is tried); shortest-side resize and
    center crop to the resolution, frames in [-1, 1]; a random
    conditioning frame, resized to 224 for the CLIP branch.
  - `SyntheticVideoDataset`: random clips in the same layout.
  - `PrefetchLoader`: per-epoch shuffled batches, loaded and collated by a
    thread pool.
The metadata is read with the stdlib csv module, with pandas'
`read_csv(dtype=str)` semantics for missing values; video files are
decoded and resized with OpenCV, imported when a clip is read (the card's
machine has none). Under several data ranks each process loads only its
rows of every global batch (`PrefetchLoader`'s `shard`, set by the
trainer from the mesh), where the JAX loader shards by host.
"""

from __future__ import annotations

import collections
import csv
import logging
import os
import random
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer
from open_pandora_tpu_torch.utils.video_io import (import_cv2, probe_video,
                                                   read_video_frames)

log = logging.getLogger("open_pandora_tpu_torch.data")

# the strings pandas' read_csv reads as missing by default
NA_VALUES = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))


def read_metadata(path: str) -> List[Dict[str, Optional[str]]]:
    """The CSV's rows as {column: str or None (missing)}; blank lines are
    skipped, short rows padded with None."""
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = []
        for fields in reader:
            if not fields:
                continue
            fields = fields + [None] * (len(header) - len(fields))
            rows.append({k: None if v is None or v in NA_VALUES else v
                         for k, v in zip(header, fields)})
    return rows


def resize_center_crop(frames: np.ndarray, height: int,
                       width: int) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (t, height, width, 3) uint8: shortest-side
    resize (area filter when shrinking, bilinear when growing), then
    center crop."""
    cv2 = import_cv2()
    _, h, w, _ = frames.shape
    scale = max(height / h, width / w)
    nh, nw = round(h * scale), round(w * scale)
    interp = cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR
    out = np.stack([cv2.resize(f, (nw, nh), interpolation=interp)
                    for f in frames])
    top, left = (nh - height) // 2, (nw - width) // 2
    return out[:, top: top + height, left: left + width]


class WebVidDataset:
    """WebVid clips; `random.Random(seed)` draws the stride, the start
    frame and the conditioning frame, in the JAX package's order."""

    def __init__(self, meta_path: str, data_dir: str,
                 video_length: int = 16,
                 resolution: Sequence[int] = (320, 512),
                 frame_stride: int = 6, frame_stride_min: int = 1,
                 random_fs: bool = False, fixed_fps: Optional[int] = None,
                 fps_max: Optional[int] = None, rand_cond_frame: bool = True,
                 subsample: Optional[int] = None, seed: int = 0):
        self.data_dir = data_dir
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.frame_stride = frame_stride
        self.frame_stride_min = frame_stride_min
        self.random_fs = random_fs
        self.fixed_fps = fixed_fps
        self.fps_max = fps_max
        self.rand_cond_frame = rand_cond_frame
        self.rng = random.Random(seed)

        rows = read_metadata(meta_path)
        if subsample:   # pandas' DataFrame.sample(n, random_state=0)
            pick = np.random.RandomState(0).choice(len(rows), size=subsample,
                                                   replace=False)
            rows = [rows[i] for i in pick]
        for r in rows:
            r["caption"] = r["name"]
        self.metadata = [r for r in rows if all(
            r[k] is not None for k in ("caption", "page_dir", "videoid"))]
        log.info(">>> %d data samples loaded.", len(self.metadata))

    def __len__(self) -> int:
        return len(self.metadata)

    def _video_path(self, row) -> str:
        return os.path.join(self.data_dir, "videos", row["page_dir"],
                            f"{row['videoid']}.mp4")

    def __getitem__(self, index: int) -> Dict:
        fs = (self.rng.randint(self.frame_stride_min, self.frame_stride)
              if self.random_fs else self.frame_stride)
        while True:
            index = index % len(self.metadata)
            row = self.metadata[index]
            path = self._video_path(row)
            try:
                frame_num, fps_ori = probe_video(path)
            except Exception as e:  # noqa: BLE001
                log.warning("Load video failed! path = %s (%s)", path, e)
                index += 1
                continue
            if frame_num < self.video_length:
                log.warning("video length (%d) < target (%d): %s",
                            frame_num, self.video_length, path)
                index += 1
                continue
            stride = fs
            if self.fixed_fps is not None:
                stride = int(stride * (fps_ori / self.fixed_fps))
            stride = max(stride, 1)
            required = stride * (self.video_length - 1) + 1
            if frame_num < required:
                if self.fixed_fps is not None and frame_num < required * 0.5:
                    index += 1
                    continue
                stride = frame_num // self.video_length
                required = stride * (self.video_length - 1) + 1
            rand_range = frame_num - required
            start = self.rng.randint(0, rand_range) if rand_range > 0 else 0
            indices = [start + stride * i for i in range(self.video_length)]
            try:
                frames, _ = read_video_frames(path, indices=indices)
                break
            except Exception as e:  # noqa: BLE001
                log.warning("Get frames failed! path = %s (%s)", path, e)
                index += 1
                continue

        frames = resize_center_crop(frames, *self.resolution)
        cond_idx = (self.rng.randint(0, self.video_length - 1)
                    if self.rand_cond_frame else 0)
        cond224 = import_cv2().resize(frames[cond_idx], (224, 224))
        video = frames.astype(np.float32) / 127.5 - 1.0
        fps_clip = int(fps_ori // stride)
        if self.fps_max is not None:
            fps_clip = min(fps_clip, self.fps_max)
        return {
            "video": video,                                    # (T,H,W,3)
            "cond_frames": video[cond_idx: cond_idx + 1],      # (1,H,W,3)
            "cond_image": cond224.astype(np.float32) / 255.0,  # (224,224,3)
            "caption": str(row["caption"]),
            "fps": fps_clip,
            "frame_stride": stride,
        }


class SyntheticVideoDataset:
    """Random clips in the WebVid sample layout, `length` of them, sample i
    seeded by seed + i."""

    length = 64
    seed = 0

    def __init__(self, video_length: int = 16,
                 resolution: Sequence[int] = (320, 512),
                 clip_size: int = 224):
        self.video_length = video_length
        self.resolution = tuple(resolution)
        self.clip_size = clip_size

    def __len__(self):
        return self.length

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState(self.seed + index % self.length)
        h, w = self.resolution
        video = rng.uniform(-1, 1, (self.video_length, h, w, 3)
                            ).astype(np.float32)
        c = self.clip_size
        return {
            "video": video,
            "cond_frames": video[:1],
            "cond_image": rng.uniform(0, 1, (c, c, 3)).astype(np.float32),
            "caption": f"synthetic clip {index}",
            "fps": 8,
            "frame_stride": 1,
        }


class PrefetchLoader:
    """Batches of `batch_size` samples in a per-epoch order seeded by
    seed + epoch, loaded and collated by a thread pool that keeps up to
    `num_workers` batches in flight; captions are tokenized to the fixed
    CLIP length. With an `llm_tokenizer` (the LLM stages) the batch also
    holds `llm_text_tokens` (b, llm_text_len): bos + caption ids, cut or
    zero-padded to the fixed length.

    `batch_size` is the global batch; with `shard=(rank, n)` this loader
    loads and yields only rows [rank * b, (rank + 1) * b) of each, b =
    batch_size / n, in the order the single-process loader gives them."""

    num_workers = 4
    seed = 0

    def __init__(self, dataset, batch_size: int, text_len: int = 77,
                 llm_tokenizer=None, llm_text_len: int = 16,
                 shard: Tuple[int, int] = (0, 1)):
        if batch_size % shard[1]:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{shard[1]} data ranks")
        self.ds = dataset
        self.bs = batch_size
        self.shard = shard
        self.text_len = text_len
        self.tokenize = load_clip_tokenizer(context_length=text_len)
        self.llm_tokenizer = llm_tokenizer
        self.llm_text_len = llm_text_len

    def _epoch_indices(self, epoch: int) -> List[int]:
        return list(np.random.RandomState(self.seed + epoch).permutation(
            len(self.ds)))

    def _load(self, indices: List[int]) -> Dict[str, np.ndarray]:
        samples = [self.ds[i] for i in indices]
        batch = {
            "video": np.stack([s["video"] for s in samples]),
            "cond_frames": np.stack([s["cond_frames"] for s in samples]),
            "cond_images": np.stack([s["cond_image"] for s in samples]),
            "text_tokens": np.stack([
                np.asarray(self.tokenize(s["caption"], self.text_len),
                           np.int32) for s in samples]),
            "fps": np.asarray([s["fps"] for s in samples], np.int32),
        }
        if self.llm_tokenizer is not None:
            n = self.llm_text_len
            ids = np.zeros((len(samples), n), np.int32)
            for i, s in enumerate(samples):
                enc = self.llm_tokenizer.encode(s["caption"],
                                                add_bos=True)[:n]
                ids[i, :len(enc)] = enc
            batch["llm_text_tokens"] = ids
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's full batches, in order (the remainder is dropped)."""
        idx = self._epoch_indices(epoch)
        rank, n = self.shard
        b = self.bs // n
        batches = iter([idx[i + rank * b:i + (rank + 1) * b]
                        for i in range(0, len(idx) - self.bs + 1, self.bs)])
        with ThreadPoolExecutor(self.num_workers) as pool:
            pending: collections.deque = collections.deque()
            for b in batches:
                pending.append(pool.submit(self._load, b))
                if len(pending) == self.num_workers:
                    break
            while pending:
                batch = pending.popleft().result()
                nxt: Optional[List[int]] = next(batches, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load, nxt))
                yield batch
