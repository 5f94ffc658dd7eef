"""Flash attention forward: the CUDA kernel (csrc/flash_fwd.cu), its plain
PyTorch version, and the wrapper that picks between them by device.

Counterpart of open_pandora_tpu/ops/flash_attention.py (Pallas
`_fwd_kernel_single` / `_fwd_kernel`). Serves the UNet's spatial
self-attention at N >= 512 and the VAE mid-block attention (one head of
width 512).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.attention_xla import NEG_INF, causal_mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = False,
                          sm_scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: returns o (B, N, H, D) in
    q.dtype and the fp32 log-sum-exp (B, H, N). Scores and statistics are
    fp32; the unnormalised probabilities are cast to v's dtype for the
    product with v, as the kernel does."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if causal:
        s = torch.where(causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    l_inv = torch.where(l == 0, 1.0, 1.0 / l)            # (B, H, N, 1)
    o = acc * l_inv.permute(0, 2, 1, 3)
    lse = (m + torch.log(torch.clamp(l, min=1e-37)))[..., 0]
    return o.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    kernels.check_qkv("flash_attention", q, k, v)
    D = q.shape[3]
    if D % 8 or D > 512:
        raise ValueError(f"flash_attention: D must be a multiple of 8 up to "
                         f"512, got {D}")
    for t in (q, k, v):
        # the kernel copies rows in 32-bit words
        if t.data_ptr() % 4 or any((s * t.element_size()) % 4
                                   for s in t.stride()[:3]):
            raise ValueError("flash_attention: rows must be 4-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, sm_scale: Optional[float] = None,
                    return_lse: bool = False):
    """Attention over q (B, N, H, D) and k/v (B, M, H, D) -> (B, N, H, D)
    [and the fp32 LSE (B, H, N)]. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
    else:
        o, lse = _flash_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
    return (o, lse) if return_lse else o


flash_attention.launches = 0


def _flash_cuda(q, k, v, *, causal, sm_scale):
    _check(q, k, v)
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
