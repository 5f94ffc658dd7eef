"""Frozen conditioning encoders: OpenCLIP ViT-H text and vision towers and
the Perceiver Resampler; and the CLIP text transformer over input
embeddings that `use_diffusion_text_encoder` puts after the connector.

Counterpart of open_pandora_tpu/models/encoders.py. Parameter names follow
the open_clip state dict (`transformer.resblocks.0.attn.in_proj_weight`,
`ln_final.weight`, ...) and the Resampler's (`layers.0.0.to_kv.weight`).
The text tower stops one block before the end (penultimate layer); the
vision tower returns all 257 tokens without ln_post. Attention goes through
the dispatcher; at these lengths (77, 257, 513 keys) it takes the plain
route.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import (CLIPTextConfig,
                                                CLIPVisionConfig,
                                                ResamplerConfig)
from open_pandora_tpu_torch.models.layers import Conv2d, LayerNorm
from open_pandora_tpu_torch.ops.attention import attention

SOT_TOKEN = 49406
EOT_TOKEN = 49407
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def empty_prompt_tokens(batch: int = 1, context_length: int = 77,
                        device=None) -> torch.Tensor:
    """Token ids of the empty prompt: [SOT, EOT, 0, ...]."""
    ids = torch.zeros((batch, context_length), dtype=torch.int64,
                      device=device)
    ids[:, 0] = SOT_TOKEN
    ids[:, 1] = EOT_TOKEN
    return ids


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """images (b, h, w, 3) in [0, 1] -> resized to size x size and
    CLIP-normalized. The resize is bilinear with antialiasing, as
    jax.image.resize(..., "bilinear") does when it downscales."""
    b, h, w, c = images.shape
    if (h, w) != (size, size):
        x = F.interpolate(images.float().permute(0, 3, 1, 2),
                          size=(size, size), mode="bilinear",
                          align_corners=False, antialias=True)
        images = x.permute(0, 2, 3, 1).to(images.dtype)
    mean = torch.tensor(CLIP_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=images.dtype, device=images.device)
    return (images - mean) / std


class _MultiheadAttention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in-projection)."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = nn.Linear(d, 4 * d)
        self.c_proj = nn.Linear(4 * d, d)


class ResidualAttentionBlock(nn.Module):
    """open_clip pre-LN block: ln_1 -> MHA -> +, ln_2 -> MLP(GELU) -> +."""

    # forward reads attn's in-projection: one FSDP unit
    fsdp_unit = True

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(d)
        self.attn = _MultiheadAttention(d)
        self.ln_2 = LayerNorm(d)
        self.mlp = _MLP(d)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        b, n, d = x.shape
        dh = d // self.heads
        qkv = F.linear(self.ln_1(x), self.attn.in_proj_weight,
                       self.attn.in_proj_bias)
        q, k, v = (t.view(b, n, self.heads, dh) for t in qkv.chunk(3, dim=-1))
        o = attention(q, k, v, causal=causal).reshape(b, n, d)
        x = x + self.attn.out_proj(o)
        y = F.gelu(self.mlp.c_fc(self.ln_2(x)))
        return x + self.mlp.c_proj(y)


class _Transformer(nn.Module):
    def __init__(self, d: int, heads: int, layers: int):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(d, heads) for _ in range(layers))


class CLIPTextEncoder(nn.Module):
    """OpenCLIP text tower, penultimate layer: (b, 77) ids -> (b, 77, d)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.empty(cfg.context_length, cfg.width))
        n_blocks = cfg.layers - (1 if cfg.penultimate else 0)
        self.transformer = _Transformer(cfg.width, cfg.heads, n_blocks)
        self.ln_final = LayerNorm(cfg.width)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding(token_ids) + self.positional_embedding
        for blk in self.transformer.resblocks:
            x = blk(x, causal=True)
        return self.ln_final(x)


class CLIPTextEmbeddingEncoder(nn.Module):
    """JAX `CLIPTextEmbeddingEncoder` (reference CLIPTextEmbeddingModel):
    all `layers` causal blocks over input embeddings (b, n, width), no
    token or position embedding added, then `ln_final`. Parameters under
    `transformer.resblocks.i` and `ln_final`, as the text tower's."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.transformer = _Transformer(cfg.width, cfg.heads, cfg.layers)
        self.ln_final = LayerNorm(cfg.width)

    def forward(self, inputs_embeds: torch.Tensor) -> torch.Tensor:
        x = inputs_embeds.to(self.ln_final.weight.dtype)
        for blk in self.transformer.resblocks:
            x = blk(x, causal=True)
        return self.ln_final(x)


class CLIPVisionEncoder(nn.Module):
    """OpenCLIP ViT visual tower: preprocessed (b, 224, 224, 3) ->
    (b, 257, width), cls token first, no ln_post."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Conv2d(3, cfg.width, cfg.patch_size,
                            stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(cfg.width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, cfg.width))
        self.ln_pre = LayerNorm(cfg.width)
        self.transformer = _Transformer(cfg.width, cfg.heads, cfg.layers)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b = images.shape[0]
        x = self.conv1(images).reshape(b, -1, self.cfg.width)
        cls = self.class_embedding.expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding
        x = self.ln_pre(x)
        for blk in self.transformer.resblocks:
            x = blk(x)
        return x


class PerceiverAttention(nn.Module):
    """Keys and values over concat(image features, latents)."""

    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, l, _ = latents.shape
        h, dh = self.heads, self.dim_head
        q = self.to_q(latents).view(b, l, h, dh)
        kv_in = torch.cat([x, latents], dim=-2)
        k, v = self.to_kv(kv_in).chunk(2, dim=-1)
        m = kv_in.shape[1]
        out = attention(q, k.view(b, m, h, dh), v.view(b, m, h, dh))
        return self.to_out(out.reshape(b, l, h * dh))


class _FeedForward(nn.Sequential):
    """LayerNorm -> Linear -> GELU -> Linear (indices 0, 1, 3 hold
    parameters, as in the reference)."""

    def __init__(self, dim: int, mult: int):
        super().__init__(LayerNorm(dim), nn.Linear(dim, dim * mult, bias=False),
                         nn.GELU(), nn.Linear(dim * mult, dim, bias=False))


class Resampler(nn.Module):
    """image_proj_model: num_queries * video_length learned latents, `depth`
    Perceiver blocks, projection to the UNet context width."""

    def __init__(self, cfg: ResamplerConfig):
        super().__init__()
        self.cfg = cfg
        nq = cfg.num_queries * (cfg.video_length or 1)
        self.latents = nn.Parameter(torch.empty(1, nq, cfg.dim))
        self.proj_in = nn.Linear(cfg.embedding_dim, cfg.dim)
        self.proj_out = nn.Linear(cfg.dim, cfg.output_dim)
        self.norm_out = LayerNorm(cfg.output_dim)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(cfg.dim, cfg.dim_head,
                                              cfg.heads),
                           _FeedForward(cfg.dim, cfg.ff_mult)])
            for _ in range(cfg.depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lat = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        return self.norm_out(self.proj_out(lat))
