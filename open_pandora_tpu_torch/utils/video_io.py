"""Frame conversion for the session's outputs.

Counterpart of `frames_to_uint8` and `concat_rounds` in
open_pandora_tpu/utils/video_io.py; reading and writing video files
(OpenCV there) waits for a later slice.
"""

from __future__ import annotations

from typing import List

import numpy as np


def frames_to_uint8(video: np.ndarray) -> np.ndarray:
    """[-1, 1] float (t, h, w, 3) -> uint8: clamp, (x + 1) / 2 * 255,
    truncated."""
    x = np.clip(np.asarray(video, dtype=np.float32), -1.0, 1.0)
    return ((x + 1.0) * 127.5).astype(np.uint8)


def concat_rounds(round_frames: List[np.ndarray]) -> np.ndarray:
    """Multi-round overlap trimming: every round but the last contributes
    all but its last 4 frames (they seed the next round); the last round
    contributes all of its frames."""
    out = [fr if i == len(round_frames) - 1 else fr[: fr.shape[0] - 4]
           for i, fr in enumerate(round_frames)]
    return np.concatenate(out, axis=0)
