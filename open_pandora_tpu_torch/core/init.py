"""Random weights from an explicit generator, for runs without a checkpoint.

The JAX package zero-initialises the output layers of every residual
branch (ResBlock out_conv, temporal conv4, transformer proj_out,
fps_embedding.2, the UNet's final conv), which makes a freshly initialised
UNet output exactly 0 and hides every layer behind it. Here every matrix
and kernel is drawn N(0, 1/fan_in), so no layer stays zero and activations
keep unit scale through depth; norm scales (RMSNorm's too) are 1, biases and
1-D embeddings small and random, the Resampler latents N(0, 1/dim). The
LLM-side families fall under the same rules: embedding tables, position
embeddings and the connector's prefix rows are matrices (rows of norm about
1), the Q-Former's query tokens N(0, 1/(77 * 768)) ahead of its LayerNorm.
LoRA adapters keep their own init (A Kaiming-uniform, B zeros), so a fresh
adapter adds nothing.
"""

from __future__ import annotations

import torch
from torch import nn

from open_pandora_tpu_torch.models.llama import LoRAAdapter
from open_pandora_tpu_torch.models.lora import is_adapter


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Overwrite every parameter of `model` in place; the generator must be
    on the parameters' device."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if is_adapter(name):
            continue
        if name.endswith("latents"):
            p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
        elif p.ndim >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif leaf == "weight":   # norm scales
            p.fill_(1.0)
        else:                    # biases, class embedding, gates
            p.normal_(0.0, 0.02, generator=generator)
    for m in model.modules():
        if isinstance(m, LoRAAdapter):
            m.reset_adapter(generator)
    return model
