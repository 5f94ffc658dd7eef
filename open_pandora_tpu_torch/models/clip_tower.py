"""CLIP ViT-L/14 vision tower of the LLM (ChatUniVi's frozen encoder).

Counterpart of open_pandora_tpu/models/clip_tower.py. HF CLIPVisionModel
semantics: bias-free patch convolution, class embedding plus learned
position embedding, `pre_layrnorm` (HF's spelling) before the encoder,
quick_gelu, LayerNorm eps 1e-5, separate q/k/v projections. The tower
returns the hidden states of layer `select_layer` (-2: all but the last
layer run, so only those are built) without the CLS token: 256 patch tokens
per 224**2 image.

Module and parameter names follow the HF `vision_model` state dict
(`embeddings.patch_embedding.weight`, `encoder.layers.0.self_attn.q_proj`,
`encoder.layers.0.mlp.fc1`), so a checkpoint's keys load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from open_pandora_tpu_torch.core.config import CLIPTowerConfig
from open_pandora_tpu_torch.models.layers import Conv2d, LayerNorm
from open_pandora_tpu_torch.ops.attention import attention


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _Embeddings(nn.Module):
    # forward reads position_embedding's weight: one FSDP unit
    fsdp_unit = True

    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        grid = cfg.image_size // cfg.patch_size
        self.patch_embedding = Conv2d(3, cfg.width, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.position_embedding = nn.Embedding(grid * grid + 1, cfg.width)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(images).flatten(1, 2)     # (b, grid^2, c)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embedding.weight


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        q, k, v = (p(x).view(b, n, self.heads, d // self.heads)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        return self.out_proj(attention(q, k, v).reshape(b, n, d))


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    """Pre-LN block: layer_norm1 -> attention -> +, layer_norm2 -> MLP -> +."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = _SelfAttention(d, heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = _MLP(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Encoder(nn.Module):
    def __init__(self, d: int, heads: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(CLIPEncoderLayer(d, heads)
                                    for _ in range(layers))


class CLIPVisionTower(nn.Module):
    """Preprocessed images (b, size, size, 3) -> (b, grid^2, width): the
    hidden states of layer `select_layer`, CLS dropped."""

    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.width)
        # select_layer = -2: all but the last |select_layer| - 1 layers run
        n_run = cfg.layers + 1 + cfg.select_layer
        self.encoder = _Encoder(cfg.width, cfg.heads, n_run)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.pre_layrnorm(self.embeddings(images))
        for layer in self.encoder.layers:
            x = layer(x)
        return x[:, 1:]
