"""Attention dispatcher: the flash kernel for long sequences, the
small-attention kernel for tiny sequences over a huge batch, plain attention
for everything else.

Counterpart of open_pandora_tpu/ops/attention.py, with the same shape gates.
Where the JAX package asks "on a TPU?", this asks "on a CUDA device?": a CPU
tensor always takes the plain route, as JAX on the CPU does.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from open_pandora_tpu_torch.ops.attention_xla import mha
from open_pandora_tpu_torch.ops.flash_attention import flash_attention
from open_pandora_tpu_torch.ops.small_attention import (
    small_attention, small_attention_eligible)
from open_pandora_tpu_torch.parallel.sp import (current_sp, ring_attention,
                                                sp_eligible)

# below this q*kv size the score matrix is small enough that the plain route
# costs little
FLASH_MIN_Q = 512
FLASH_MIN_KV = 256


def attention_route(q_shape: Sequence[int], k_shape: Sequence[int], *,
                    causal: bool, masked: bool, on_device: bool) -> str:
    """'flash' | 'small' | 'plain' for q (B, N, H, D) and k (B, M, H, D)."""
    b, n, h = q_shape[0], q_shape[1], q_shape[2]
    m = k_shape[1]
    if on_device and not masked and n >= FLASH_MIN_Q and m >= FLASH_MIN_KV:
        return "flash"
    if (on_device and not masked and not causal
            and small_attention_eligible(n, m, b * h)):
        return "small"
    return "plain"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = False, mask: Optional[torch.Tensor] = None,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, q (B, N, H, D), k/v (B, M, H, D) -> (B, N, H, D).
    mask broadcasts to (B, H, N, M), True = attend; a mask forces the plain
    route. Inside parallel.sp.sequence_parallel, eligible causal
    self-attention (LLaMA prefill) takes the ring over the mesh's data axis
    (q, k, v are then this rank's sequence shards)."""
    if sp_eligible(q.shape, k.shape, causal, mask):
        return ring_attention(q, k, v, ms=current_sp(), sm_scale=sm_scale,
                              causal=True)
    route = attention_route(q.shape, k.shape, causal=causal,
                            masked=mask is not None, on_device=q.is_cuda)
    if route == "flash":
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    if route == "small":
        return small_attention(q, k, v, sm_scale=sm_scale)
    return mha(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)
