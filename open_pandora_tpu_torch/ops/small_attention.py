"""Attention for tiny sequences over a huge batch: the CUDA kernel
(csrc/small_attn_fwd.cu), its plain PyTorch version, and the wrapper that
picks between them by device.

Counterpart of open_pandora_tpu/ops/small_attention.py (Pallas
`_fwd_kernel`). Serves the UNet's temporal self-attention (N = M = t = 16,
batch b*h*w).
"""

from __future__ import annotations

from typing import Optional

import torch

from open_pandora_tpu_torch.ops import kernels

LANES = 128
MAX_SEQ = 32
MAX_HEAD_DIM = 128


def small_attention_eligible(n: int, m: int, batch_heads: int) -> bool:
    """Shapes the kernel targets: both sequence lengths tiny, batch*heads at
    least 128 (the JAX package's gate, kept so both route alike)."""
    return n <= MAX_SEQ and m <= MAX_SEQ and batch_heads >= LANES


def small_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, sm_scale: Optional[float] = None
                          ) -> torch.Tensor:
    """The kernel's function in plain PyTorch: every step in fp32."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    kernels.check_qkv("small_attention", q, k, v)
    N, M, D = q.shape[1], k.shape[1], q.shape[3]
    if N > MAX_SEQ or M > MAX_SEQ or D > MAX_HEAD_DIM:
        raise ValueError(f"small_attention: needs N, M <= {MAX_SEQ} and "
                         f"D <= {MAX_HEAD_DIM}, got N={N}, M={M}, D={D}")


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Unmasked attention, q (B, N, H, D), k/v (B, M, H, D), N and M tiny.
    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    if q.device.type == "cpu":
        return small_attention_plain(q, k, v, sm_scale=sm_scale)
    _check(q, k, v)
    B, N, H, D = q.shape
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_small_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N,
            k.shape[1], H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), kernels.DTYPE_CODES[q.dtype],
            kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_small_attn_fwd")
    small_attention.launches += 1
    return o


small_attention.launches = 0
