"""Plain multi-head attention: the route for masked and small shapes, and the
reference the kernels are held to.

Counterpart of open_pandora_tpu/ops/attention_xla.py: scores and softmax in
fp32, the probabilities cast to v's dtype for the product with v.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -0.7 * torch.finfo(torch.float32).max


def causal_mask(n: int, m: int, device) -> torch.Tensor:
    """(n, m) bool, True = attend; aligns the end of q with the end of k
    (col <= row + m - n), so m >= n works as a suffix."""
    row = torch.arange(n, device=device)[:, None]
    col = torch.arange(m, device=device)[None, :]
    return col <= row + (m - n)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = False, mask: Optional[torch.Tensor] = None,
        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q (B, N, H, D), k/v (B, M, H, D) -> (B, N, H, D) in q.dtype. mask
    broadcasts to (B, H, N, M), True = attend."""
    scale = sm_scale if sm_scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if causal:
        s = torch.where(causal_mask(s.shape[-2], s.shape[-1], s.device), s,
                        NEG_INF)
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
