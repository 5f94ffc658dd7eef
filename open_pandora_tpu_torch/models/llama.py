"""LLaMA-7B trunk, prefill-oriented.

Counterpart of open_pandora_tpu/models/llama.py. HF LLaMA semantics:
RMSNorm eps 1e-6 (fp32 statistics, the scale after the cast back), rotary
embeddings over the full head width in two contiguous halves, SwiGLU MLP,
pre-norm residual blocks. The world model calls the bare trunk on spliced
input embeddings and reads hidden states only; `lm_head` serves the SFT
loss (train/llm_step.py). With `lora_rank > 0` every projection but
`lm_head` is a `LoRALinear` (JAX `LoRADense`): the frozen base plus a
low-rank adapter. With `quantize` "int8" (or True) or "nf4" every
projection, lm_head included, is weight-only quantized (models/quant.py:
`Int8Linear`, `NF4Linear`; JAX `Int8Dense`, `Int4Dense`), a LoRA
projection over such a base too. `models.quant.quantize_llama_` turns a
float model into that layout.

Module and parameter names follow the HF state dict
(`model.embed_tokens.weight`, `model.layers.0.self_attn.q_proj.weight`,
`model.norm.weight`, `lm_head.weight`); an adapter adds `….q_proj.lora_a`
(in, r) and `….q_proj.lora_b` (r, out), the JAX package's layout; a
quantized projection holds `….weight_q` and `….scale`, or `….weight_p`
and `….absmax`, in place of `….weight`.

Token ids: <image> = 32000 (= vocab_size, the splice marker), [IMG_P] =
32001 (the connector's learned-prefix slots).
"""

from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import LLaMAConfig
from open_pandora_tpu_torch.models.quant import (QUANT_LINEAR, Int8Linear,
                                                 NF4Linear, quant_mode)
from open_pandora_tpu_torch.ops.attention import attention
from open_pandora_tpu_torch.ops.norms import rms_norm

IMAGE_TOKEN_ID = 32000
IMG_PREFIX_TOKEN_ID = 32001


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, eps=self.eps)


def rotary_embed(x: torch.Tensor, positions: torch.Tensor,
                 theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE in fp32. x (b, n, h, d); positions (b, n) or (n,). HF
    LLaMA layout: rotate_half over two contiguous halves of the head."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                             device=x.device) / d))
    if positions.ndim == 1:
        positions = positions[None, :]
    freqs = positions[..., None].float() * inv_freq          # (b, n, d/2)
    cos = torch.cos(freqs)[:, :, None, :]
    sin = torch.sin(freqs)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class LoRAAdapter:
    """A low-rank adapter over a frozen bias-free base projection (the
    class it is mixed into): y = base(x) + ((x A) B) α/r (PEFT semantics:
    A Kaiming-uniform on fan_in, B zeros, so the delta starts at 0). AB is
    never formed. No LoRA dropout, as in the JAX package's deterministic
    SFT step."""

    def _add_adapter(self, rank: int, alpha: float) -> None:
        self.rank, self.alpha = rank, alpha
        self.lora_a = nn.Parameter(torch.empty(self.in_features, rank))
        self.lora_b = nn.Parameter(torch.empty(rank, self.out_features))
        self.reset_adapter()

    @torch.no_grad()
    def reset_adapter(self, generator: Optional[torch.Generator] = None
                      ) -> None:
        """flax he_uniform over (in, r): U(+-sqrt(6 / in)); B = 0."""
        bound = math.sqrt(6.0 / self.in_features)
        self.lora_a.uniform_(-bound, bound, generator=generator)
        self.lora_b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        delta = (x @ self.lora_a.to(x.dtype)) @ self.lora_b.to(x.dtype)
        return super().forward(x) + delta * (self.alpha / self.rank)


class LoRALinear(LoRAAdapter, nn.Linear):
    """JAX `LoRADense` over a float base."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float):
        nn.Linear.__init__(self, in_features, out_features, bias=False)
        self._add_adapter(rank, alpha)


class LoRAInt8Linear(LoRAAdapter, Int8Linear):
    """JAX `LoRADense` over an int8 base."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float):
        Int8Linear.__init__(self, in_features, out_features)
        self._add_adapter(rank, alpha)


class LoRANF4Linear(LoRAAdapter, NF4Linear):
    """JAX `LoRADense` over an NF4 base."""

    def __init__(self, in_features: int, out_features: int, rank: int,
                 alpha: float):
        NF4Linear.__init__(self, in_features, out_features)
        self._add_adapter(rank, alpha)


LORA_LINEAR = {False: LoRALinear, "int8": LoRAInt8Linear,
               "nf4": LoRANF4Linear}


def _base_linear(d_in: int, d_out: int, quantize) -> nn.Module:
    """JAX `_base_dense`: plain, int8 or NF4."""
    if quantize:
        return QUANT_LINEAR[quant_mode(quantize)](d_in, d_out)
    return nn.Linear(d_in, d_out, bias=False)


def _proj(cfg: LLaMAConfig, d_in: int, d_out: int, quantize=False
          ) -> nn.Module:
    """JAX `_proj`: a LoRA projection when cfg.lora_rank > 0, else the
    base alone."""
    if cfg.lora_rank:
        return LORA_LINEAR[quantize](d_in, d_out, cfg.lora_rank,
                                     cfg.lora_alpha)
    return _base_linear(d_in, d_out, quantize)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LLaMAConfig, quantize=False):
        super().__init__()
        self.heads, self.theta = cfg.num_heads, cfg.rope_theta
        d = cfg.hidden_size
        self.q_proj = _proj(cfg, d, d, quantize)
        self.k_proj = _proj(cfg, d, d, quantize)
        self.v_proj = _proj(cfg, d, d, quantize)
        self.o_proj = _proj(cfg, d, d, quantize)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # the head width from the projections: under tensor parallelism
        # (parallel/tp.py) this rank holds `heads` of them
        b, n, _ = x.shape
        q, k, v = (p(x).view(b, n, self.heads, -1)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        q = rotary_embed(q, positions, self.theta)
        k = rotary_embed(k, positions, self.theta)
        o = attention(q, k, v, causal=True, mask=mask)
        return self.o_proj(o.reshape(b, n, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LLaMAConfig, quantize=False):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _proj(cfg, d, m, quantize)
        self.up_proj = _proj(cfg, d, m, quantize)
        self.down_proj = _proj(cfg, m, d, quantize)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LLaMAConfig, quantize=False):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = LlamaAttention(cfg, quantize)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = LlamaMLP(cfg, quantize)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.self_attn(self.input_layernorm(x), positions, mask)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaTrunk(nn.Module):
    """The bare LlamaModel: input embeddings (b, n, hidden) -> hidden
    states. Holds the embedding table, as HF's does."""

    def __init__(self, cfg: LLaMAConfig, quantize=False):
        super().__init__()
        self.embed_tokens = nn.Embedding(cfg.total_vocab, cfg.hidden_size)
        self.layers = nn.ModuleList(LlamaLayer(cfg, quantize)
                                    for _ in range(cfg.num_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)

    def forward(self, inputs_embeds: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """positions (b, n) or (n,), default arange(n); attention_mask
        (b, n), True = a real key, combined with the causal mask."""
        if positions is None:
            positions = torch.arange(inputs_embeds.shape[1],
                                     device=inputs_embeds.device)
        mask = None
        if attention_mask is not None:
            mask = attention_mask[:, None, None, :].bool()
        x = inputs_embeds.to(self.norm.weight.dtype)
        for layer in self.layers:
            x = layer(x, positions, mask)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Trunk, embedding and lm_head. The conditioning path calls `embed`
    and `trunk` only. `quantized` is False, "int8" or "nf4"."""

    def __init__(self, cfg: LLaMAConfig, quantize=False):
        super().__init__()
        self.cfg = cfg
        self.quantized = quant_mode(quantize)
        self.model = LlamaTrunk(cfg, self.quantized)
        self.lm_head = _base_linear(cfg.hidden_size, cfg.total_vocab,
                                    self.quantized)

    def embed(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.model.embed_tokens(token_ids)

    def trunk(self, inputs_embeds: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.model(inputs_embeds, positions, attention_mask)

    def forward(self, token_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        h = self.model(self.embed(token_ids), attention_mask=attention_mask)
        return self.lm_head(h)
