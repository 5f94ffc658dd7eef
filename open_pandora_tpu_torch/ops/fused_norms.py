"""GroupNorm(+SiLU) over channel-last bf16 slabs: the CUDA kernel
(csrc/group_norm_silu.cu), its plain version, and the wrapper that picks
between them by device.

Counterpart of open_pandora_tpu/ops/fused_norms.py (Pallas `_kernel`).
Serves every GroupNorm of the UNet and the VAE on the bf16 eval route. The
plain version is ops/norms.group_norm: fp32 statistics, the Pallas kernel's
function.
"""

from __future__ import annotations

import torch

from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.norms import group_norm

# blocks per pass the split plan aims at: four per SM of an H100 (132 SMs)
_TARGET_BLOCKS = 4 * 132
_MAX_SPLITS = 256
_MIN_ROWS_PER_SPLIT = 16


def fused_group_norm_silu(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor, *, num_groups: int = 32,
                          eps: float = 1e-5, silu: bool = False
                          ) -> torch.Tensor:
    """GroupNorm(+SiLU) over channel-last x (N, ..., C), statistics per
    sample over all middle dims. bf16 slabs with ndim >= 3 and C divisible
    by num_groups route to the kernel where `kernels.fused_available(x)`;
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
                    and kernels.fused_available(x))
    if not kernel_route or x.device.type == "cpu":
        # the plain route, or the kernel's plain version for a CPU tensor
        return group_norm(x, weight, bias, num_groups=num_groups, eps=eps,
                          silu=silu)
    return _gn_cuda(x, weight, bias, num_groups=num_groups, eps=eps,
                    silu=silu)


fused_group_norm_silu.launches = 0


def _split_plan(n: int, rows: int) -> tuple:
    """(S, rows_per_split): each sample's rows cut into S splits so that
    the (S, n) grid of either pass fills the card."""
    s = -(-_TARGET_BLOCKS // n)
    s = max(1, min(s, _MAX_SPLITS, rows // _MIN_ROWS_PER_SPLIT))
    per = -(-rows // s)
    return -(-rows // per), per


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
    splits, per = _split_plan(n, rows)
    part = torch.empty((n, splits, num_groups, 3), dtype=torch.float32,
                       device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = kernels.library().pandora_group_norm_silu(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            part.data_ptr(), out.data_ptr(), n, rows, c, num_groups, splits,
            per, float(eps), int(silu), kernels.DTYPE_CODES[x.dtype],
            kernels.stream_handle(x))
    kernels.check_cuda(err, "pandora_group_norm_silu")
    fused_group_norm_silu.launches += 1
    return out
