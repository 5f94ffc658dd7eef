"""Random weights from an explicit generator, for runs without a checkpoint.

The JAX package zero-initialises the output layers of every residual
branch (ResBlock out_conv, temporal conv4, transformer proj_out,
fps_embedding.2, the UNet's final conv), which makes a freshly initialised
UNet output exactly 0 and hides every layer behind it. Here every matrix
and kernel is drawn N(0, 1/fan_in), so no layer stays zero and activations
keep unit scale through depth; norm scales are 1, biases and 1-D
embeddings small and random, the Resampler latents N(0, 1/dim).
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter of `model` in place; the generator must be
    on the parameters' device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if name.endswith("latents"):
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
        elif p.ndim >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif leaf == "weight":   # norm scales
            p.fill_(1.0)
        else:                    # biases, class embedding, gates
            p.normal_(0.0, 0.02, generator=generator)
    return model
