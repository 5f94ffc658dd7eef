"""The trainable connector: learned [IMG_P] prefix rows, a BLIP-2 Q-Former
and two projections, mapping the LLM's hidden states into the diffusion
model's cross-attention space.

Counterpart of open_pandora_tpu/models/connector.py:
  - image_prefix: Linear(4096, 64, bias=False) whose weight rows are the 64
    learned prefix embeddings substituted at the [IMG_P] positions;
  - diffusion_qformer_proj: Linear 4096 -> 768;
  - diffusion_qformer: HF Blip2QFormerModel (12 layers, hidden 768, BERT
    post-LN blocks with eps 1e-12, cross-attention on every second layer,
    the query-path feed-forward with exact-erf gelu);
  - diffusion_query_tokens: (1, 77, 768) learned queries;
  - diffusion_proj: Linear 768 -> 1024.
Module and parameter names are the released checkpoint's
(`diffusion_qformer.encoder.layer.0.crossattention.attention.query.weight`,
`diffusion_qformer.encoder.layer.0.output_query.LayerNorm.weight`, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import ConnectorConfig, QFormerConfig
from open_pandora_tpu_torch.models.layers import LayerNorm
from open_pandora_tpu_torch.ops.attention import attention


class _SelfOutput(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d, d)
        self.LayerNorm = LayerNorm(d, eps)


class _QKV(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)


class BertAttention(nn.Module):
    """BERT-style attention block: multi-head attention, output dense,
    residual, LayerNorm. kv=None self-attends."""

    def __init__(self, d: int, heads: int, eps: float):
        super().__init__()
        self.heads = heads
        self.attention = _QKV(d)
        self.output = _SelfOutput(d, eps)

    def forward(self, x: torch.Tensor,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        kv = x if kv is None else kv
        b, n, d = x.shape
        dh = d // self.heads
        a = self.attention
        o = attention(a.query(x).view(b, n, self.heads, dh),
                      a.key(kv).view(b, -1, self.heads, dh),
                      a.value(kv).view(b, -1, self.heads, dh))
        o = self.output.dense(o.reshape(b, n, d))
        return self.output.LayerNorm(o + x)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class _OutputQuery(nn.Module):
    def __init__(self, d_in: int, d_out: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = LayerNorm(d_out, eps)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross: bool):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertAttention(d, cfg.num_heads, eps)
        if has_cross:
            self.crossattention = BertAttention(d, cfg.num_heads, eps)
        # the query-path feed-forward: every token here is a query
        self.intermediate_query = _Dense(d, cfg.intermediate_size)
        self.output_query = _OutputQuery(cfg.intermediate_size, d, eps)

    def forward(self, x: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        x = self.attention(x)
        if hasattr(self, "crossattention"):
            x = self.crossattention(x, encoder_hidden_states)
        y = F.gelu(self.intermediate_query.dense(x))
        return self.output_query.LayerNorm(self.output_query.dense(y) + x)


class _QFormerEncoder(nn.Module):
    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0)
            for i in range(cfg.num_layers))


class QFormer(nn.Module):
    """Blip2QFormerModel over query embeddings, cross-attending to
    encoder_hidden_states (the projected LLM hidden states)."""

    def __init__(self, cfg: QFormerConfig):
        super().__init__()
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.encoder = _QFormerEncoder(cfg)

    def forward(self, query_embeds: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        x = self.layernorm(query_embeds)
        for layer in self.encoder.layer:
            x = layer(x, encoder_hidden_states)
        return x


class Connector(nn.Module):
    """image_prefix rows; qformer_proj -> Q-Former -> proj."""

    # prefix_embeddings reads image_prefix's weight: one FSDP unit, with
    # that method gathered as forward is
    fsdp_unit = True
    fsdp_methods = ("prefix_embeddings",)

    def __init__(self, cfg: ConnectorConfig, qcfg: QFormerConfig):
        super().__init__()
        self.image_prefix = nn.Linear(cfg.llm_hidden,
                                      cfg.image_prefix_length, bias=False)
        self.diffusion_qformer_proj = nn.Linear(cfg.llm_hidden,
                                                cfg.qformer_proj_dim)
        self.diffusion_query_tokens = nn.Parameter(
            torch.empty(1, qcfg.num_query_tokens, qcfg.hidden_size))
        self.diffusion_qformer = QFormer(qcfg)
        self.diffusion_proj = nn.Linear(qcfg.hidden_size, cfg.proj_out_dim)

    def prefix_embeddings(self) -> torch.Tensor:
        """The learned [IMG_P] prefix rows (prefix_length, llm_hidden)."""
        return self.image_prefix.weight

    def forward(self, imgp_hidden: torch.Tensor) -> torch.Tensor:
        """imgp_hidden (n, 64, 4096), the LLM's hidden states at the
        [IMG_P] positions -> (n, 77, proj_out_dim) conditioning."""
        enc = self.diffusion_qformer_proj(
            imgp_hidden.to(self.diffusion_query_tokens.dtype))
        queries = self.diffusion_query_tokens.expand(imgp_hidden.shape[0],
                                                     -1, -1)
        return self.diffusion_proj(self.diffusion_qformer(queries, enc))
