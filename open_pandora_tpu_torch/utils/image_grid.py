"""Sample grids: a clip's frames side by side, one row per sample, as PNG.

Counterpart of open_pandora_tpu/utils/image_grid.py (the reference's
ImageLogger, utils/callbacks.py:15-101). The PNG is written with the
stdlib (zlib, 8-bit RGB, filter 0 on every row), so it needs no image
library: the card's machine has none.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def video_grid(video: np.ndarray, max_frames: int = 8) -> np.ndarray:
    """(t, h, w, 3) float in [-1, 1] or uint8 -> one row of at most
    `max_frames` evenly strided frames, (h, w * n, 3) uint8."""
    v = np.asarray(video)
    if v.dtype != np.uint8:
        v = ((np.clip(v, -1, 1) + 1) * 127.5).astype(np.uint8)
    step = max(1, v.shape[0] // max_frames)
    return np.concatenate(list(v[::step][:max_frames]), axis=1)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def write_png(path: str, rgb: np.ndarray) -> str:
    """(h, w, 3) uint8 -> an 8-bit RGB PNG at `path`."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected (h, w, 3) RGB, got {rgb.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),     # filter 0
                           rgb.reshape(h, w * 3)], axis=1)
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
    return path


def save_sample_grid(path: str, videos: np.ndarray,
                     max_items: int = 4) -> str:
    """(b, t, h, w, 3) -> the first `max_items` samples' frame rows,
    stacked, as one PNG."""
    grid = np.concatenate([video_grid(v) for v in videos[:max_items]],
                          axis=0)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return write_png(path, grid)
