"""Autoregressive decoding for the ChatUniVi LLM: a KV cache, greedy or
sampled.

Counterpart of open_pandora_tpu/models/llama_generate.py. The world model's
conditioning never decodes; the ChatUniVi answer runners do
(eval/chatunivi_qa.py, eval/scienceqa.py, eval/consistency.py).

  prefill_cache       the trunk over the prompt through ops.attention
                      (causal; the flash kernel on the card from 512 rows),
                      recording each layer's k (after RoPE) and v into
                      caches allocated once, (b, max_len, h, dh) a layer
  decode_step         one position through every layer, plain PyTorch as
                      JAX's einsum step: q·kᵀ in fp32 scaled by dh^-½,
                      masked to the cached positions with NEG_INF, softmax
                      in fp32, p cast to the cache dtype, the product with
                      v accumulated in fp32
  first_token_logits  (b, vocab) logits of the token after the prompt
  greedy_generate     the row of tokens fed, starting with argmax of the
                      first logits; a sequence that fed eos is done and
                      every later token is eos
  decode_tokens       greedy_generate's loop after its prefill

The decode loop is a host loop over positions with no host sync: `done`
and the eos padding stay tensors, as in JAX's lax.scan. JAX computes one
more next token after the last and drops it; this skips that step. With
`temperature > 0` and a `generator`, the tokens after the first are drawn
with torch.multinomial from softmax(logits / temperature): the same
distribution as jax.random.categorical, not the same draws.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from open_pandora_tpu_torch.models.llama import (LlamaForCausalLM,
                                                 rotary_embed)
from open_pandora_tpu_torch.ops.attention import attention
from open_pandora_tpu_torch.ops.attention_xla import NEG_INF

Cache = List[Tuple[torch.Tensor, torch.Tensor]]


def _qkv(attn, y: torch.Tensor, positions: torch.Tensor):
    b, n, _ = y.shape
    q, k, v = (p(y).view(b, n, attn.heads, -1)
               for p in (attn.q_proj, attn.k_proj, attn.v_proj))
    return (rotary_embed(q, positions, attn.theta),
            rotary_embed(k, positions, attn.theta), v)


@torch.no_grad()
def prefill_cache(llama: LlamaForCausalLM, inputs_embeds: torch.Tensor,
                  max_len: int) -> Tuple[torch.Tensor, Cache]:
    """The trunk over the prompt (b, L, d), recording k and v per layer.
    Returns (the last row's final hidden state (b, d), the cache: per
    layer (k, v), each (b, max_len, h, dh), rows L.. zero)."""
    b, L, _ = inputs_embeds.shape
    positions = torch.arange(L, device=inputs_embeds.device)
    x = inputs_embeds.to(llama.model.norm.weight.dtype)
    cache = []
    for layer in llama.model.layers:
        attn = layer.self_attn
        q, k, v = _qkv(attn, layer.input_layernorm(x), positions)
        ck = x.new_zeros((b, max_len) + k.shape[2:])
        cv = x.new_zeros((b, max_len) + v.shape[2:])
        ck[:, :L] = k
        cv[:, :L] = v
        cache.append((ck, cv))
        o = attention(q, k, v, causal=True).reshape(b, L, -1)
        x = x + attn.o_proj(o)
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    return llama.model.norm(x)[:, -1], cache


@torch.no_grad()
def decode_step(llama: LlamaForCausalLM, tok: torch.Tensor, pos: int,
                cache: Cache) -> torch.Tensor:
    """Feed tokens `tok` (b,) at position `pos`: writes row `pos` of every
    layer's cache and returns the next logits (b, vocab)."""
    x = llama.embed(tok)[:, None]                          # (b, 1, d)
    positions = torch.tensor([pos], device=x.device)
    for layer, (ck, cv) in zip(llama.model.layers, cache):
        attn = layer.self_attn
        q, k, v = _qkv(attn, layer.input_layernorm(x), positions)
        ck[:, pos] = k[:, 0]
        cv[:, pos] = v[:, 0]
        s = torch.einsum("bqhd,bmhd->bhqm", q.float(), ck.float()) \
            * (q.shape[-1] ** -0.5)
        seen = torch.arange(ck.shape[1], device=x.device) <= pos
        p = torch.softmax(torch.where(seen, s, NEG_INF), dim=-1)
        o = torch.einsum("bhqm,bmhd->bqhd", p.to(cv.dtype).float(),
                         cv.float())
        x = x + attn.o_proj(o.reshape(x.shape[0], 1, -1).to(x.dtype))
        x = x + layer.mlp(layer.post_attention_layernorm(x))
    return llama.lm_head(llama.model.norm(x[:, 0]))


@torch.no_grad()
def first_token_logits(llama: LlamaForCausalLM,
                       inputs_embeds: torch.Tensor) -> torch.Tensor:
    """(b, vocab) pre-softmax logits of the token that would follow the
    prompt (the ScienceQA runner scores answer letters with them)."""
    last, _ = prefill_cache(llama, inputs_embeds, inputs_embeds.shape[1])
    return llama.lm_head(last)


@torch.no_grad()
def greedy_generate(llama: LlamaForCausalLM, inputs_embeds: torch.Tensor,
                    max_new_tokens: int = 64, eos_token_id: int = 2,
                    temperature: float = 0.0,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """-> (b, max_new_tokens) int64 token ids, eos after a sequence is
    done. Sampled (temperature > 0) only with a generator, on the
    model's device, as JAX samples only with a key."""
    L = inputs_embeds.shape[1]
    last, cache = prefill_cache(llama, inputs_embeds, L + max_new_tokens)
    return decode_tokens(llama, llama.lm_head(last).argmax(dim=-1), cache,
                         L, max_new_tokens, eos_token_id, temperature,
                         generator)


@torch.no_grad()
def decode_tokens(llama: LlamaForCausalLM, first: torch.Tensor, cache: Cache,
                  pos: int, max_new_tokens: int, eos_token_id: int = 2,
                  temperature: float = 0.0,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """greedy_generate after its prefill: feeds `first` (b,) at `pos`, then
    each next token, max_new_tokens - 1 decode steps in all."""
    b = first.shape[0]
    toks = torch.empty((b, max_new_tokens), dtype=torch.int64,
                       device=first.device)
    toks[:, 0] = first
    done = torch.zeros(b, dtype=torch.bool, device=first.device)
    for i in range(max_new_tokens - 1):
        tok = toks[:, i]
        logits = decode_step(llama, tok, pos + i, cache)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        done |= tok == eos_token_id
        toks[:, i + 1] = torch.where(done, eos_token_id, nxt)
    return toks
