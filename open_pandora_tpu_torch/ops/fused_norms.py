"""GroupNorm(+SiLU) over channel-last bf16 slabs: the CUDA kernel
(csrc/group_norm_silu.cu), its plain version, and the wrapper that picks
between them by device.

Counterpart of open_pandora_tpu/ops/fused_norms.py (Pallas `_kernel`).
Serves every GroupNorm of the UNet and the VAE on the bf16 eval route. The
plain version is ops/norms.group_norm: fp32 statistics, the Pallas kernel's
function.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.norms import group_norm
from open_pandora_tpu_torch.utils import profiling

SMS = 132                  # streaming multiprocessors of an H100
_STATS_BLOCKS = SMS        # pass 1: one wave of long-running blocks
_APPLY_BLOCKS = 8 * SMS    # pass 2: short blocks, many in flight


class LaunchPlan(NamedTuple):
    """How csrc/group_norm_silu.cu runs one slab: pass 1 on grid
    (splits, N), `per` rows a block; pass 2 on grid (splits N, chunks),
    each pass-1 block's rows in chunks of `chunk_rows`; `threads` per block
    of either pass."""
    per: int
    threads: int
    splits: int
    chunk_rows: int
    chunks: int


def _split(n: int, rows: int, blocks: int) -> tuple:
    """(rows a block, blocks a sample) for about `blocks` blocks in all,
    at least `blocks` where there are that many rows."""
    per = max(1, rows // -(-blocks // n))
    return per, -(-rows // per)


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, rows: int, c: int) -> LaunchPlan:
    """One thread per 8-channel column, as many rows of them as 384
    threads hold (at least one), rounded up to whole warps: the kernels'
    two blocks a multiprocessor where c <= 3072, 1024 threads at c = 8192.
    Pass 1 fills one wave of the card's multiprocessors, pass 2 eight."""
    vc = c // 8
    threads = -(-(vc * max(1, 384 // vc)) // 32) * 32
    per, splits = _split(n, rows, _STATS_BLOCKS)
    chunk_rows, chunks = _split(n * splits, per, _APPLY_BLOCKS)
    return LaunchPlan(per, threads, splits, chunk_rows, chunks)


def fused_group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int = 32,
                          eps: float = 1e-5, silu: bool = False
                          ) -> torch.Tensor:
    """GroupNorm(+SiLU) over channel-last x (N, ..., C), statistics per
    sample over all middle dims. bf16 slabs with ndim >= 3 and C divisible
    by num_groups route to the kernel where `kernels.fused_available(x)`
    and neither PANDORA_DISABLE_FUSED nor PANDORA_DISABLE_FUSED_GN is set
    (`_fused_gn_available`, ops/fused_norms.py:300-305);
    everything else takes the plain version. A CPU tensor on the kernel
    route gets the plain version; a CUDA tensor gets the kernel or an
    exception."""
    eligible = x.ndim >= 3 and x.shape[-1] % num_groups == 0
    # No slab bound: the JAX package caps the resident kernel at
    # _MAX_SLAB_ELEMS = 3 * 2**19 elements (ops/fused_norms.py:43), the
    # TPU's VMEM residency limit, and above it falls back to _mxu_group_norm
    # (:263-287), an XLA rewrite around XLA's fp32 upcast. The card has
    # neither problem: the two-pass kernel takes every bf16 slab, the
    # (2, 40960, 320) temporal conv slabs, the (32, 2560, 640/960) decoder
    # concats and the (8, 163840, 128) VAE decode slabs included.
    kernel_route = (eligible and x.dtype == torch.bfloat16
                    and kernels.fused_available(x)
                    and not flags.flag("PANDORA_DISABLE_FUSED")
                    and not flags.flag("PANDORA_DISABLE_FUSED_GN"))
    if not kernel_route or x.device.type == "cpu":
        # the plain route, or the kernel's plain version for a CPU tensor
        return group_norm(x, weight, bias, num_groups=num_groups, eps=eps,
                          silu=silu)
    return _gn_cuda(x, weight, bias, num_groups=num_groups, eps=eps,
                    silu=silu)


fused_group_norm_silu.launches = 0


def check_shapes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 num_groups: int) -> None:
    """What the kernel takes, device aside: bf16 x (N, ..., C) contiguous
    and 16-byte aligned, C divisible by num_groups and by 8, at most 8192;
    bf16 weight and bias (C,)."""
    name = "fused_group_norm_silu"
    c = x.shape[-1]
    if x.dtype != torch.bfloat16 or weight.dtype != x.dtype \
            or bias.dtype != x.dtype:
        raise ValueError(f"{name}: needs bf16 x, weight and bias, got "
                         f"{x.dtype}/{weight.dtype}/{bias.dtype}")
    if x.ndim < 3 or c % num_groups or c % 8 or c > 8192 or x.numel() == 0 \
            or weight.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, "
                         f"{tuple(weight.shape)}, {tuple(bias.shape)} for "
                         f"{num_groups} groups (C % 8 == 0, C <= 8192)")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be contiguous and 16-byte aligned")
    if not (weight.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name}: weight and bias must be contiguous")


def _gn_cuda(x, weight, bias, *, num_groups, eps, silu):
    kernels.check_cuda_tensors("fused_group_norm_silu", x, weight, bias)
    check_shapes(x, weight, bias, num_groups)
    n, c = x.shape[0], x.shape[-1]
    rows = x.numel() // (n * c)
    plan = launch_plan(n, rows, c)
    # pass 1's partial moments, the per-channel scale and shift, then the
    # samples' tickets (zeroed by the launcher on the stream)
    scratch = torch.empty(n * plan.splits * num_groups * 3 + n * c * 2 + n,
                          dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = kernels.library().pandora_group_norm_silu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            scratch.data_ptr(), out.data_ptr(), n, rows, c, num_groups,
            plan.per, plan.threads, plan.splits, plan.chunk_rows,
            plan.chunks, float(eps), int(silu), kernels.DTYPE_CODES[x.dtype],
            kernels.stream_handle(x))
    kernels.check_cuda(err, "pandora_group_norm_silu")
    fused_group_norm_silu.launches += 1
    if profiling.recording():
        profiling.count("group_norm_silu", (
            tuple(x.shape), num_groups, str(x.dtype).removeprefix("torch.")))
    return out
