"""Host-side frame preprocessing in C++ (native/preproc.cpp), through ctypes.

Counterpart of open_pandora_tpu/native/__init__.py. The library is built
with g++ on first use into `build/` at the repository root, under a name
keyed on a hash of the source and the flags, so a second run loads the
one it finds; nothing is built when this module is imported. A failed
build raises with the compiler's message: there is no fallback. The
plain NumPy versions beside the wrappers compute the same function (the
tests hold the library to them):

  resize_center_crop_normalize(frames_u8, (H, W), scale, offset)
      (t, h, w, 3) uint8 -> (t, H, W, 3) float32: bilinear
      (align_corners=False) at the virtual shortest-side resize that
      covers (H, W), center crop, then x / 255 * scale + offset per channel
  u8_to_pm1(frames_u8) -> float32 in [-1, 1]
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "native" / "preproc.cpp"
BUILD_DIR = REPO / "build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_U8P = ctypes.POINTER(ctypes.c_uint8)
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path(build_dir: Optional[Path] = None) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    return Path(build_dir or BUILD_DIR) / \
        f"libpandora_preproc_{h.hexdigest()[:16]}.so"


def build(build_dir: Optional[Path] = None) -> Path:
    """Compile native/preproc.cpp unless the library already exists."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    done = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC),
                           "-lpthread"], capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"g++ could not build {SRC}:\n{done.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library(build_dir: Optional[Path] = None) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(build_dir)))
    lib.preprocess_frames.argtypes = [
        _U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P, _F32P, ctypes.c_int]
    lib.u8_to_pm1.argtypes = [_U8P, _F32P, ctypes.c_int64, ctypes.c_int]
    return lib


def _threads(num_threads: int) -> int:
    return num_threads or min(8, os.cpu_count() or 1)


def resize_dims(sh: int, sw: int, dh: int, dw: int) -> Tuple[int, int]:
    """The shortest-side resize of (sh, sw) that covers (dh, dw)."""
    scale = max(dh / sh, dw / sw)
    return max(dh, round(sh * scale)), max(dw, round(sw * scale))


def resize_center_crop_normalize(
        frames: np.ndarray, out_hw: Tuple[int, int],
        scale: Sequence[float] = (1.0, 1.0, 1.0),
        offset: Sequence[float] = (0.0, 0.0, 0.0), num_threads: int = 0,
        build_dir: Optional[Path] = None) -> np.ndarray:
    """(t, h, w, 3) uint8 -> (t, H, W, 3) float32 in the C++ library, one
    thread per frame (up to 8 by default)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, sh, sw, _ = frames.shape
    dh, dw = out_hw
    rh, rw = resize_dims(sh, sw, dh, dw)
    sc = np.ascontiguousarray(scale, np.float32)
    of = np.ascontiguousarray(offset, np.float32)
    out = np.empty((t, dh, dw, 3), np.float32)
    library(build_dir).preprocess_frames(
        frames.ctypes.data_as(_U8P), t, sh, sw, out.ctypes.data_as(_F32P),
        dh, dw, rh, rw, sc.ctypes.data_as(_F32P), of.ctypes.data_as(_F32P),
        _threads(num_threads))
    return out


def _taps(n_out: int, first: int, n_src: int, n_virtual: int):
    """Source rows (or columns) and weights of the align-corners-false
    bilinear sample at outputs first .. first + n_out - 1 of a virtual
    length n_virtual, in float32 as the C++ computes them."""
    f32 = np.float32
    step = f32(n_src) / f32(n_virtual)
    pos = (np.arange(first, first + n_out).astype(f32) + f32(0.5)) * step \
        - f32(0.5)
    pos = np.clip(pos, f32(0.0), f32(n_src - 1))
    lo = pos.astype(np.int64)
    return lo, np.minimum(lo + 1, n_src - 1), pos - lo.astype(f32)


def resize_center_crop_normalize_plain(
        frames: np.ndarray, out_hw: Tuple[int, int],
        scale: Sequence[float] = (1.0, 1.0, 1.0),
        offset: Sequence[float] = (0.0, 0.0, 0.0)) -> np.ndarray:
    """The library's function in NumPy."""
    frames = np.asarray(frames, dtype=np.uint8)
    _, sh, sw, _ = frames.shape
    dh, dw = out_hw
    rh, rw = resize_dims(sh, sw, dh, dw)
    y0, y1, wy = _taps(dh, (rh - dh) // 2, sh, rh)
    x0, x1, wx = _taps(dw, (rw - dw) // 2, sw, rw)
    one = np.float32(1.0)
    wy, wx = wy[:, None, None], wx[None, :, None]
    src = frames.astype(np.float32)
    r0, r1 = src[:, y0], src[:, y1]
    v = ((one - wy) * (one - wx) * r0[:, :, x0]
         + (one - wy) * wx * r0[:, :, x1]
         + wy * (one - wx) * r1[:, :, x0] + wy * wx * r1[:, :, x1])
    return (v * (one / np.float32(255.0)) * np.float32(scale)
            + np.float32(offset)).astype(np.float32)


def u8_to_pm1(frames: np.ndarray, num_threads: int = 0,
              build_dir: Optional[Path] = None) -> np.ndarray:
    """uint8 -> float32 x * 2 / 255 - 1 in the C++ library."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    out = np.empty(frames.shape, np.float32)
    library(build_dir).u8_to_pm1(frames.ctypes.data_as(_U8P),
                                 out.ctypes.data_as(_F32P), frames.size,
                                 _threads(num_threads))
    return out


def u8_to_pm1_plain(frames: np.ndarray) -> np.ndarray:
    """The library's u8_to_pm1 in NumPy."""
    x = np.asarray(frames, dtype=np.uint8).astype(np.float32)
    return x * (np.float32(2.0) / np.float32(255.0)) - np.float32(1.0)
