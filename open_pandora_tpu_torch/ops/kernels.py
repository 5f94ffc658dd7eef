"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by nvcc for sm_90a into one shared library with a
plain C interface, loaded through ctypes. The build runs on first use, into
`build/` at the repository root, under a name keyed on a hash of the
sources and flags, so a second run loads the library it finds. Nothing is
compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pandora_flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_F, _I, _I, _P],
    "pandora_small_attn_fwd": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _I, _P],
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpandora_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it already exists.
    The ptxas report (registers, shared memory, spills) is kept beside it
    as a .log file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_qkv(name: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """What both attention kernels require: q (B, N, H, D) and k, v
    (B, M, H, D) on one CUDA device, one supported dtype, N and M > 0, the
    head dim contiguous."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: unsupported dtypes "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    if (q.ndim != 4 or k.ndim != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"{name}: empty sequence")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")


def check_cuda(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
