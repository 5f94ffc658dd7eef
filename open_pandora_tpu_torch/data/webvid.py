"""Training data: the synthetic video dataset and the batching loader.

Counterpart of SyntheticVideoDataset and PrefetchLoader in
open_pandora_tpu/data/webvid.py, with the same sample and batch contract
(train/step.py) and the same seeds. `WebVidDataset` waits: it decodes and
resizes with OpenCV, which the card's machine does not have. One process
reads everything (the JAX loader's per-host sharding waits for the
multi-device slice).
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer


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
    CLIP length."""

    num_workers = 4
    seed = 0

    def __init__(self, dataset, batch_size: int, text_len: int = 77):
        self.ds = dataset
        self.bs = batch_size
        self.text_len = text_len
        self.tokenize = load_clip_tokenizer(context_length=text_len)

    def _epoch_indices(self, epoch: int) -> List[int]:
        return list(np.random.RandomState(self.seed + epoch).permutation(
            len(self.ds)))

    def _load(self, indices: List[int]) -> Dict[str, np.ndarray]:
        samples = [self.ds[i] for i in indices]
        return {
            "video": np.stack([s["video"] for s in samples]),
            "cond_frames": np.stack([s["cond_frames"] for s in samples]),
            "cond_images": np.stack([s["cond_image"] for s in samples]),
            "text_tokens": np.stack([
                np.asarray(self.tokenize(s["caption"], self.text_len),
                           np.int32) for s in samples]),
            "fps": np.asarray([s["fps"] for s in samples], np.int32),
        }

    def epoch(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """The epoch's full batches, in order (the remainder is dropped)."""
        idx = self._epoch_indices(epoch)
        batches = iter([idx[i:i + self.bs]
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
