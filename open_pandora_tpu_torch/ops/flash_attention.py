"""Flash attention, forward and backward: the CUDA kernels
(csrc/flash_fwd.cu, csrc/flash_bwd.cu), their plain PyTorch versions, and
the autograd Function that picks between them by device.

Counterpart of open_pandora_tpu/ops/flash_attention.py (Pallas
`_fwd_kernel_single` / `_fwd_kernel`, and the custom VJP's
`_bwd_dkv_kernel` / `_bwd_dq_kernel`). Serves the UNet's spatial
self-attention at N >= 512, in training too, and the VAE mid-block
attention (one head of width 512).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.attention_xla import NEG_INF, causal_mask

BWD_MAX_HEAD_DIM = 128
# the masked score as the kernels hold it (kMaskValue, an fp32 value), so
# that a float64 reference masks with the same number as fp32 does
MASK_VALUE = float(torch.tensor(NEG_INF, dtype=torch.float32))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: returns o (B, N, H, D) in
    q.dtype and the fp32 log-sum-exp (B, H, N). Scores and statistics are
    fp32; the unnormalised probabilities are cast to v's dtype for the
    product with v, as the kernel does. float64 inputs stay float64
    throughout (the card's float64 reference)."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = _scores(q, k, causal, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnm,bmhd->bnhd", _up(p.to(v.dtype)), _up(v))
    l_inv = torch.where(l == 0, 1.0, 1.0 / l)            # (B, H, N, 1)
    o = acc * l_inv.permute(0, 2, 1, 3)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o.to(q.dtype), lse


def _up(t: torch.Tensor) -> torch.Tensor:
    """t in fp32, or float64 where it is float64."""
    return t if t.dtype == torch.float64 else t.float()


def _scores(q, k, causal, scale):
    """fp32 (float64 for float64 inputs) scaled scores (B, H, N, M), causal
    entries masked."""
    s = torch.einsum("bnhd,bmhd->bhnm", _up(q), _up(k)) * scale
    if causal:
        s = torch.where(causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        MASK_VALUE)
    return s


def _row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o do) in fp32, (B, H, N) contiguous (`_bwd`'s di)."""
    return (_up(o) * _up(do)).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = False,
                              sm_scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's function in plain PyTorch (`_bwd`): p
    recomputed from the forward's LSE, di = rowsum(o do), dv = p^T do,
    dp = do v^T, ds = p (dp - di) scale, dq = ds k, dk = ds^T q; all in
    fp32 (float64 for float64 inputs), outputs in the inputs' dtypes."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    p = torch.exp(_scores(q, k, causal, scale) - _up(lse)[..., None])
    dof = _up(do)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dof)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, _up(v))
    ds = p * (dp - _row_dot(o, do)[..., None]) * scale
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, _up(k))
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, _up(q))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           align: int = 4) -> None:
    """What the kernels take: `check_qkv`, D a multiple of 8 up to 512,
    rows `align`-byte aligned (pointer and every stride)."""
    kernels.check_qkv("flash_attention", q, k, v)
    D = q.shape[3]
    if D % 8 or D > 512:
        raise ValueError(f"flash_attention: D must be a multiple of 8 up to "
                         f"512, got {D}")
    for t in (q, k, v):
        kernels.check_aligned("flash_attention", t, align)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (or its plain version on a CPU tensor), saving q,
    k, v, o and the LSE; the backward kernel (or its plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           sm_scale=scale)
        else:
            o, lse = _flash_cuda(q, k, v, causal=causal, sm_scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         sm_scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention over q (B, N, H, D) and k/v (B, M, H, D) -> (B, N, H, D)
    [and the fp32 LSE (B, H, N)], differentiable in q, k and v. A CUDA
    tensor launches the kernels; a CPU tensor takes the plain versions."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    o, lse = _FlashAttention.apply(q, k, v, causal, float(scale))
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                        sm_scale: Optional[float] = None):
    """dq, dk, dv of flash_attention: the backward kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         sm_scale=sm_scale)
    return _flash_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                           sm_scale=sm_scale)


flash_attention_bwd.launches = 0


def _flash_cuda(q, k, v, *, causal, sm_scale):
    # bf16 rows go through 16-byte cp.async copies; fp32 rows through
    # 16-byte copies where every row is 16-byte aligned, else 4-byte ones
    _check(q, k, v, 16 if q.dtype == torch.bfloat16 else 4)
    B, N, H, D = q.shape
    M = k.shape[1]
    scale = sm_scale if sm_scale is not None else D ** -0.5
    o = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), B, N, M, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], float(scale), int(causal),
            kernels.DTYPE_CODES[q.dtype], kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_flash_fwd")
    flash_attention.launches += 1
    return o, lse


def _flash_bwd_cuda(q, k, v, o, lse, do, *, causal, sm_scale):
    # bf16 rows go through 16-byte cp.async copies; fp32 rows through
    # 16-byte copies where every row is 16-byte aligned, else 4-byte ones
    align = 16 if q.dtype == torch.bfloat16 else 4
    if do.stride(-1) != 1 or do.data_ptr() % align or any(
            (s * do.element_size()) % align for s in do.stride()[:-1]):
        do = do.contiguous()
    _check(q, k, v, align)
    _check(do, k, v, align)
    B, N, H, D = q.shape
    M = k.shape[1]
    if D > BWD_MAX_HEAD_DIM:
        raise ValueError(f"flash_attention backward: D must be at most "
                         f"{BWD_MAX_HEAD_DIM}, got {D}")
    if lse.shape != (B, H, N) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention backward: bad lse {lse.shape} "
                         f"{lse.dtype}")
    scale = sm_scale if sm_scale is not None else D ** -0.5
    lse = lse.contiguous()
    di = _row_dot(o, do)
    dq = torch.empty((B, N, H, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, M, H, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, M, H, D), dtype=v.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernels.library().pandora_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, N, M, H, D, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *do.stride()[:3], float(scale), int(causal),
            kernels.DTYPE_CODES[q.dtype], kernels.stream_handle(q))
    kernels.check_cuda(err, "pandora_flash_bwd")
    flash_attention_bwd.launches += 1
    return dq, dk, dv
