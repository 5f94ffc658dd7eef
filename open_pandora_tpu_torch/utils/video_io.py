"""Host-side video I/O (OpenCV) and frame conversion.

Counterpart of open_pandora_tpu/utils/video_io.py: `write_video` (h264,
else mp4v), `read_video_frames` (explicit indices or uniform sampling),
`probe_video`, `frames_to_uint8` and `concat_rounds`. OpenCV is imported
when a file is read or written, not with this module: the card's machine
has none, and a call there raises ImportError naming it. `HAVE_CV2` says
whether it can be imported.
"""

from __future__ import annotations

import importlib.util
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

HAVE_CV2 = importlib.util.find_spec("cv2") is not None


def import_cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError("video files are read and written with OpenCV "
                          "(the cv2 package), which is not installed") from e
    return cv2


def write_video(path: str, frames: np.ndarray, fps: int = 8) -> str:
    """frames (t, h, w, 3) uint8 RGB -> mp4: h264 (avc1) where the build
    has it, else mp4v."""
    cv2 = import_cv2()
    _, h, w, _ = frames.shape
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    for codec in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*codec), fps,
                                 (w, h))
        if writer.isOpened():
            for fr in frames:
                writer.write(cv2.cvtColor(fr, cv2.COLOR_RGB2BGR))
            writer.release()
            return path
        writer.release()
    raise RuntimeError(f"no usable mp4 codec for {path}")


def read_video_frames(path: str, indices: Optional[Sequence[int]] = None,
                      num_frames: Optional[int] = None
                      ) -> Tuple[np.ndarray, float]:
    """Decode RGB frames: the given `indices`, else `num_frames` sampled
    uniformly, else all. An index past the last decodable frame takes the
    last one. Returns (frames (t, h, w, 3) uint8, fps)."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    if indices is None:
        indices = (range(total) if num_frames is None else
                   np.linspace(0, max(total - 1, 0), num_frames).astype(int))
    want = {int(i) for i in indices}
    last_wanted = max(want) if want else -1
    frames = {}
    pos = 0
    while pos <= last_wanted:
        ok, frame = cap.read()
        if not ok:
            break
        if pos in want:
            frames[pos] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        pos += 1
    cap.release()
    if not frames:
        raise IOError(f"no decodable frames in {path}")
    last = frames[max(frames)]
    return np.stack([frames.get(int(i), last) for i in indices]), fps


def probe_video(path: str) -> Tuple[int, float]:
    """(frame count, fps), after checking that the first frame decodes."""
    cv2 = import_cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise IOError(f"cannot open video {path}")
        ok, _ = cap.read()
        if not ok:
            raise IOError(f"no decodable frames in {path}")
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    finally:
        cap.release()
    return total, fps


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
