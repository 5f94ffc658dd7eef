"""Blockwise 8-bit AdamW: both Adam moments stored as int8 with one fp32
absmax scale per `block_size` elements.

Counterpart of open_pandora_tpu/train/optim8bit.py (the analog of
bitsandbytes' 8-bit optimizers), in plain torch with its own quantisation:
each update dequantizes a parameter's moments, runs the AdamW math in fp32
and requantizes them. The parameters are visited one at a time, so at most
one parameter's fp32 moments exist at once (the JAX package orders its
leaves with optimization barriers to the same end). The chain is optax's:
scale by the bias-corrected Adam ratio, add `weight_decay * param`, scale
by -lr, add to the parameter.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np
import torch

# the JAX package's scale_by_adam8bit default
BLOCK_SIZE = 2048


class Quantized(NamedTuple):
    q: torch.Tensor        # int8 payload, padded flat (n_blocks * block)
    scale: torch.Tensor    # fp32 absmax per block (n_blocks,)


def quantize(x: torch.Tensor, block: int) -> Quantized:
    """Signed sqrt code: q = round(127 sign(v) sqrt(|v| / absmax)),
    v = scale sign(q) (q / 127)^2. Like bitsandbytes' dynamic map it puts
    its resolution near zero, where a linear int8 code rounds small moment
    entries to 0 every step."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, block)
    scale = blocks.abs().amax(dim=1)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    unit = torch.sqrt(blocks.abs() / safe[:, None])
    q = torch.round(127.0 * torch.sign(blocks) * unit).clamp_(-127, 127)
    return Quantized(q=q.to(torch.int8).view(-1), scale=scale)


def dequantize(qv: Quantized, shape: Sequence[int], block: int
               ) -> torch.Tensor:
    qf = qv.q.view(-1, block).float() / 127.0
    blocks = torch.sign(qf) * qf.square() * qv.scale[:, None]
    n = int(np.prod(shape, dtype=np.int64))
    return blocks.view(-1)[:n].view(tuple(shape))


class AdamW8bit:
    """AdamW over `params` with int8 blockwise moments. step(lr) applies
    one update from the parameters' .grad (every grad must be set)."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, block_size: int = BLOCK_SIZE):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.block = weight_decay, block_size
        self.count = 0

        def zeros(p):
            return quantize(torch.zeros(p.shape, device=p.device),
                            block_size)
        self.mu: List[Quantized] = [zeros(p) for p in self.params]
        self.nu: List[Quantized] = [zeros(p) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        b1, b2 = self.b1, self.b2
        # 1 - b^count in fp32, as the JAX package computes them
        c = np.float32(self.count)
        bc1 = float(np.float32(1) - np.float32(b1) ** c)
        bc2 = float(np.float32(1) - np.float32(b2) ** c)
        for i, p in enumerate(self.params):
            g = p.grad.float()
            mu = b1 * dequantize(self.mu[i], p.shape, self.block) \
                + (1.0 - b1) * g
            nu = b2 * dequantize(self.nu[i], p.shape, self.block) \
                + (1.0 - b2) * g.square()
            upd = ((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                   ).to(p.grad.dtype)
            self.mu[i] = quantize(mu, self.block)
            self.nu[i] = quantize(nu, self.block)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.add_(-lr * upd)
