"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources are compiled by nvcc for sm_90a into one shared library with a
plain C interface, loaded through ctypes: one nvcc process per source, all
started together, then one link. The build runs on first use, into `build/`
at the repository root, under a name keyed on a hash of the sources and
flags, so a second run loads the library it finds. Nothing is compiled or
loaded when this module is imported.
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
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "pandora_flash_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_F, _I, _I, _P],
    "pandora_flash_bwd": [_P] * 9 + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P],
    "pandora_small_attn_fwd": [_P] * 4 + [_I] * 5 + [_L] * 9 + [_F, _I, _P],
    "pandora_small_attn_bwd": [_P] * 7 + [_I] * 5 + [_L] * 12
    + [_F, _I, _P],
    "pandora_group_norm_silu": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "pandora_packed_attn_fwd": [_P] * 7 + [_I] * 7 + [_L] * 12
    + [_F, _F, _I, _P],
    "pandora_fused_temporal_attn": [_P] * 9 + [_I] * 5 + [_L] * 8
    + [_F, _F, _I, _P],
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
    """Compile csrc/*.cu into the shared library unless it already exists:
    every source in its own nvcc process, all at once, then one link. The
    ptxas report (registers, shared memory, spills) is kept beside it as a
    .log file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out.with_name(f"{out.stem}.{src.stem}.{tag}.o")
        jobs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in jobs:
        text = proc.communicate()[0]
        log.append(f"== {src.name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{text}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_name(f"{out.name}.{tag}")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text("".join(log))
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
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


def fused_available(x: torch.Tensor) -> bool:
    """Whether the fused kernels of the JAX package's default bf16 eval
    route (GroupNorm+SiLU, packed attention, fused temporal attention) serve
    x: true on a CUDA device. Counterpart of `_fused_available`
    (open_pandora_tpu/models/unet3d.py) and `_fused_gn_available`
    (ops/fused_norms.py), which ask for a TPU. Callers read it through this
    module, so a test can monkeypatch it in one place."""
    return x.is_cuda


def check_cuda_tensors(name: str, *tensors: torch.Tensor) -> None:
    """All on the first tensor's CUDA device and outside autograd: the
    kernels are forward-only, and their outputs carry no gradient."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one CUDA device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel is forward-only; call it "
                           "under torch.no_grad()")


def check_aligned(name: str, t: torch.Tensor, nbytes: int) -> None:
    """t's data pointer and every stride but the last (unit) one are
    multiples of nbytes."""
    if (t.stride(-1) != 1 or t.data_ptr() % nbytes
            or any((s * t.element_size()) % nbytes for s in t.stride()[:-1])):
        raise ValueError(f"{name}: rows must be contiguous and {nbytes}-byte "
                         f"aligned, got strides {t.stride()}")


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
