"""Attention for tiny sequences over a huge batch, forward and backward:
the CUDA kernels (csrc/small_attn_fwd.cu, csrc/small_attn_bwd.cu), their
plain PyTorch versions, and the autograd Function that picks between them
by device.

Counterpart of open_pandora_tpu/ops/small_attention.py (Pallas
`_fwd_kernel`, and the custom VJP's `_bwd_kernel`). Serves the UNet's
temporal self-attention (N = M = t = 16, batch b*h*w), in training too.
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


def small_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              sm_scale: Optional[float] = None):
    """The backward kernel's function in plain PyTorch (`_bwd_kernel`),
    every step in fp32: p recomputed, dv = p^T do, dp = do v^T,
    ds = p (dp - rowsum(dp p)) scale, dq = ds k, dk = ds^T q."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    dof = do.float()
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, v.float())
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _SmallAttention(torch.autograd.Function):
    """The forward kernel (or its plain version on a CPU tensor), saving q,
    k and v; the backward kernel (or its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        if q.device.type == "cpu":
            o = small_attention_plain(q, k, v, sm_scale=scale)
        else:
            o = _small_cuda(q, k, v, sm_scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = small_attention_bwd(q, k, v, do, sm_scale=ctx.scale)
        return dq, dk, dv, None


def small_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Unmasked attention, q (B, N, H, D), k/v (B, M, H, D), N and M tiny;
    differentiable in q, k and v. A CUDA tensor launches the kernels; a CPU
    tensor takes the plain versions."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    return _SmallAttention.apply(q, k, v, float(scale))


small_attention.launches = 0


def small_attention_bwd(q, k, v, do, *, sm_scale: Optional[float] = None):
    """dq, dk, dv of small_attention: the backward kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return small_attention_bwd_plain(q, k, v, do, sm_scale=scale)
    return _small_bwd_cuda(q, k, v, do, sm_scale=scale)


small_attention_bwd.launches = 0


def _small_cuda(q, k, v, *, sm_scale):
    _check(q, k, v)
    B, N, H, D = q.shape
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_small_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, N,
            k.shape[1], H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(sm_scale), kernels.DTYPE_CODES[q.dtype],
            kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_small_attn_fwd")
    small_attention.launches += 1
    return o


def _small_bwd_cuda(q, k, v, do, *, sm_scale):
    do = do if do.stride(-1) == 1 else do.contiguous()
    _check(q, k, v)
    _check(do, k, v)
    B, N, H, D = q.shape
    M = k.shape[1]
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, M, H, D), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_small_attn_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, N, M, H, D,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3], float(sm_scale), kernels.DTYPE_CODES[q.dtype],
            kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_small_attn_bwd")
    small_attention_bwd.launches += 1
    return dq, dk, dv
