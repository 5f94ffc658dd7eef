"""EVA-ViT-g vision tower, ChatUniVi's alternative to the CLIP ViT-L tower.

Counterpart of open_pandora_tpu/models/eva_tower.py (reference
ChatUniVi/model/multimodal_encoder/eva_vit.py, create_eva_vit_g: patch 14,
width 1408, 39 blocks, 16 heads of 88, mlp_ratio 4.3637; eva_encoder.py).
`WorldModel` takes it when `tower_type` starts with "eva_vit_g".

Its quirks, kept: one fused qkv projection with learned q and v biases and
a k bias of zero that is not a parameter; pre-LN blocks with eps 1e-6;
exact GELU; absolute position embeddings that include the cls token; the
features are block `select_layer`'s output, before any final norm, with
cls dropped. Blocks past the selected one are built (a checkpoint holds
them) but not run. Attention takes the plain route, as the JAX package
routes this tower to its XLA attention and not to the dispatcher: it
reaches no kernel.

Parameter names follow the reference's state dict (`patch_embed.proj`,
`cls_token`, `pos_embed`, `blocks.0.norm1`, `blocks.0.attn.qkv`,
`blocks.0.attn.q_bias`, `blocks.0.attn.v_bias`, `blocks.0.attn.proj`,
`blocks.0.norm2`, `blocks.0.mlp.fc1`, `blocks.0.mlp.fc2`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import CLIPTowerConfig
from open_pandora_tpu_torch.models.dynamicrafter import _Prefix
from open_pandora_tpu_torch.models.layers import Conv2d, LayerNorm
from open_pandora_tpu_torch.ops.attention_xla import mha

LN_EPS = 1e-6


class _Attention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(d))
        self.v_bias = nn.Parameter(torch.zeros(d))
        self.proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.q_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias.to(x.dtype))
        q, k, v = qkv.view(b, n, 3, self.heads, d // self.heads).unbind(2)
        return self.proj(mha(q, k, v).reshape(b, n, d))


class _MLP(nn.Module):
    def __init__(self, d: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class EVABlock(nn.Module):
    # forward reads the q and v biases beside attn.qkv: one FSDP unit
    fsdp_unit = True

    def __init__(self, d: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.norm1 = LayerNorm(d, eps=LN_EPS)
        self.attn = _Attention(d, heads)
        self.norm2 = LayerNorm(d, eps=LN_EPS)
        self.mlp = _MLP(d, mlp_hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class EVAVisionTower(nn.Module):
    """Preprocessed images (b, size, size, 3) -> (b, grid^2, width): block
    `select_layer`'s output, cls dropped."""

    def __init__(self, cfg: CLIPTowerConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.patch_embed = _Prefix(proj=Conv2d(3, cfg.width, cfg.patch_size,
                                               stride=cfg.patch_size))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1,
                                                  cfg.width))
        mlp_hidden = int(cfg.width * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(EVABlock(cfg.width, cfg.heads, mlp_hidden)
                                    for _ in range(cfg.layers))
        self.n_run = (cfg.layers + cfg.select_layer + 1
                      if cfg.select_layer < 0 else cfg.select_layer + 1)
        if not 0 < self.n_run <= cfg.layers:
            raise ValueError(f"select_layer {cfg.select_layer} out of "
                             f"range for {cfg.layers} blocks")

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed.proj(images).flatten(1, 2)   # (b, grid^2, c)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed
        for blk in self.blocks[:self.n_run]:
            x = blk(x)
        return x[:, 1:]
