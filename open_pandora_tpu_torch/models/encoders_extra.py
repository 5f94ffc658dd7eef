"""Alternative conditioning encoders: the reference's encoder set beyond the
shipped OpenCLIP pair (DynamiCrafter lvdm/modules/encoders/condition.py:
29-176, 384-399).

Counterpart of open_pandora_tpu/models/encoders_extra.py:

  ClassEmbedder            class-conditional embedding, ucg dropout to the
                           extra class n_classes - 1 (condition.py:29-53)
  T5Encoder                FrozenT5Embedder: the T5 v1.1 encoder's
                           last_hidden_state over max-length-padded ids;
                           the reference passes no attention mask, so pads
                           are attended, and so here (condition.py:62-91)
  HFCLIPTextEncoder        FrozenCLIPEmbedder: the transformers
                           CLIPTextModel (quick-GELU MLPs) with the last /
                           pooled / hidden layer select (condition.py:94-138)
  PooledCLIPImageEncoder   ClipImageEmbedder: CLIP preprocessing of [-1, 1]
                           images, the open_clip visual tower, ln_post on
                           the cls token, the projection; whole-sample ucg
                           zeroing (condition.py:141-176)
  CLIPT5Pair               FrozenCLIPT5Encoder: [clip_z, t5_z]
                           (condition.py:384-399)

No configuration of either package uses them; core/registry.py resolves
their reference targets. Parameter names are the transformers state-dict
keys (T5EncoderModel: `shared.weight`, `encoder.block.{i}.layer.0
.SelfAttention.q.weight`, ...; CLIPTextModel: `text_model.embeddings.*`,
`text_model.encoder.layers.{i}.*`, `text_model.final_layer_norm.*`), so
each loads an HF state dict with strict=True; core/convert.py carries the
JAX package's params across. Text encoders take token ids.

Attention: T5's is plain PyTorch as in JAX (no 1/sqrt(d) scaling, fp32
scores plus the shared position bias); the CLIP text blocks go through the
dispatcher, causal. At 77 text tokens and 257 image tokens the flash gate
(q >= 512) refuses in both packages, so these encoders take the plain
route and launch no kernel of their own.

The ucg dropouts draw from an explicit torch.Generator and raise
ValueError without one, as JAX raises without a PRNG key; their draws
cannot match jax.random.bernoulli's draw for draw.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import (CLIPTextConfig,
                                                CLIPVisionConfig, T5Config)
from open_pandora_tpu_torch.models.encoders import (CLIPVisionEncoder,
                                                    clip_preprocess)
from open_pandora_tpu_torch.models.layers import LayerNorm
from open_pandora_tpu_torch.ops.attention import attention


def _need_generator(generator: Optional[torch.Generator]) -> None:
    if generator is None:
        raise ValueError("ucg dropout needs a torch.Generator")


# -- ClassEmbedder (condition.py:29-53) ---------------------------------------


class ClassEmbedder(nn.Module):
    """Labels (b,) int -> (b, 1, embed_dim). With ucg_rate > 0 each label
    becomes the unconditional class n_classes - 1 with probability
    ucg_rate (the reference reserves the last class for it)."""

    def __init__(self, embed_dim: int, n_classes: int = 1000,
                 ucg_rate: float = 0.1):
        super().__init__()
        self.n_classes, self.ucg_rate = n_classes, ucg_rate
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, labels: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                disable_dropout: bool = False) -> torch.Tensor:
        if self.ucg_rate > 0.0 and not disable_dropout:
            _need_generator(generator)
            drop = torch.rand(labels.shape, generator=generator,
                              device=labels.device) < self.ucg_rate
            labels = torch.where(drop, self.n_classes - 1, labels)
        return self.embedding(labels)[:, None, :]

    def unconditional_labels(self, batch: int) -> torch.Tensor:
        return torch.full((batch,), self.n_classes - 1, dtype=torch.int64,
                          device=self.embedding.weight.device)


# -- T5 v1.1 encoder (condition.py:62-91) -------------------------------------


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm: no mean subtraction, fp32 variance, no bias."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return w * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def _relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional bucket map (HF modeling_t5._relative_position_bucket
    with bidirectional=True): half the buckets for each sign, log-spaced
    beyond num_buckets // 4 exact positions. The log-spaced part is fp32
    throughout, the divisor's log included, so the buckets at its edges
    are the JAX package's."""
    num_buckets //= 2
    ret = (rel > 0).to(torch.int32) * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    log_ratio = torch.log(torch.tensor(max_distance / max_exact,
                                       dtype=torch.float32))
    large = max_exact + (torch.log(n.float() / max_exact + 1e-9)
                         / log_ratio.to(rel.device)
                         * (num_buckets - max_exact)).to(torch.int32)
    large = torch.clamp(large, max=num_buckets - 1)
    return ret + torch.where(is_small, n.to(torch.int32), large)


class _T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if relative_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_buckets, cfg.num_heads)

    def position_bias(self, n: int) -> torch.Tensor:
        """(1, heads, n, n): the bias of block 0, shared by every block."""
        pos = torch.arange(n, device=self.relative_attention_bias
                           .weight.device)
        rel = pos[None, :] - pos[:, None]           # memory - query
        bucket = _relative_position_bucket(rel, self.cfg.relative_buckets,
                                           self.cfg.relative_max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)[None]

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor
                ) -> torch.Tensor:
        cfg = self.cfg
        b, n, _ = x.shape
        q, k, v = (p(x).view(b, n, cfg.num_heads, cfg.d_kv)
                   for p in (self.q, self.k, self.v))
        # T5: no 1/sqrt(d) score scaling; the additive position bias
        s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float())
        p = torch.softmax(s + pos_bias.float(), dim=-1).to(v.dtype)
        o = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(b, n, -1)
        return self.o(o)


class _T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _rms_norm(x, self.weight, self.eps)


class _T5SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias: bool):
        super().__init__()
        self.SelfAttention = _T5Attention(cfg, relative_bias)
        self.layer_norm = _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class _T5DenseGatedGelu(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        # v1.1 gated-GELU (DenseGatedActDense, gelu_new = the tanh form)
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh")
                       * self.wi_1(h))


class _T5FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseGatedGelu(cfg)
        self.layer_norm = _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class _T5Block(nn.Module):
    def __init__(self, cfg: T5Config, relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_T5SelfAttentionLayer(cfg, relative_bias),
                                    _T5FFLayer(cfg)])

    def forward(self, x: torch.Tensor, pos_bias: torch.Tensor
                ) -> torch.Tensor:
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), pos_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config, embed_tokens: nn.Embedding):
        super().__init__()
        self.embed_tokens = embed_tokens        # tied to T5Encoder.shared
        self.block = nn.ModuleList(_T5Block(cfg, relative_bias=i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = _T5LayerNorm(cfg.d_model, cfg.layer_norm_eps)


class T5Encoder(nn.Module):
    """T5 v1.1 encoder stack: ids (b, n) -> last_hidden_state (b, n,
    d_model). Pads attended (no mask), the relative position bias of block
    0 shared by every block, gated-GELU FF, RMS norms, final_layer_norm.
    Eval only."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = _T5Stack(cfg, self.shared)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        enc = self.encoder
        x = self.shared(token_ids)
        pos_bias = enc.block[0].layer[0].SelfAttention.position_bias(
            token_ids.shape[1])
        for blk in enc.block:
            x = blk(x, pos_bias)
        return enc.final_layer_norm(x)


# -- huggingface CLIP text encoder (condition.py:94-138) ----------------------


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _HFCLIPAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)


class _HFCLIPMLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d)
        self.fc2 = nn.Linear(4 * d, d)


class _HFCLIPBlock(nn.Module):
    """Pre-LN block (eps 1e-5): causal attention through the dispatcher,
    quick-GELU MLP."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.self_attn = _HFCLIPAttention(d)
        self.layer_norm1 = LayerNorm(d)
        self.mlp = _HFCLIPMLP(d)
        self.layer_norm2 = LayerNorm(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        a = self.self_attn
        y = self.layer_norm1(x)
        q, k, v = (p(y).view(b, n, self.heads, d // self.heads)
                   for p in (a.q_proj, a.k_proj, a.v_proj))
        x = x + a.out_proj(attention(q, k, v, causal=True).reshape(b, n, d))
        y = _quick_gelu(self.mlp.fc1(self.layer_norm2(x)))
        return x + self.mlp.fc2(y)


class _HFCLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Embedding(cfg.context_length, cfg.width)


class _HFCLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(_HFCLIPBlock(cfg.width, cfg.heads)
                                    for _ in range(cfg.layers))


class _HFCLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _HFCLIPEmbeddings(cfg)
        self.encoder = _HFCLIPEncoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.width)


class HFCLIPTextEncoder(nn.Module):
    """FrozenCLIPEmbedder: ids (b, n) -> 'last': the final_layer_norm
    output (b, n, d); 'pooled': its row at the first argmax token id (the
    eos) of each row, (b, 1, d); 'hidden': hidden_states[layer_idx] (the
    embeddings are index 0, then each block's output before the final
    norm; a negative index counts from the end)."""

    def __init__(self, cfg: CLIPTextConfig, layer: str = "last",
                 layer_idx: Optional[int] = None):
        super().__init__()
        if layer not in ("last", "pooled", "hidden"):
            raise ValueError(f"layer {layer!r}: last, pooled or hidden")
        if layer == "hidden" and layer_idx is None:
            raise ValueError("layer 'hidden' needs a layer_idx")
        self.cfg, self.layer, self.layer_idx = cfg, layer, layer_idx
        self.text_model = _HFCLIPTextModel(cfg)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        n = token_ids.shape[1]
        x = (tm.embeddings.token_embedding(token_ids)
             + tm.embeddings.position_embedding.weight[:n])
        hidden = [x]
        for blk in tm.encoder.layers:
            x = blk(x)
            hidden.append(x)
        if self.layer == "hidden":
            return hidden[self.layer_idx]
        z = tm.final_layer_norm(x)
        if self.layer == "pooled":
            eos = token_ids.argmax(dim=-1)
            return z[torch.arange(z.shape[0], device=z.device), eos][:, None]
        return z


# -- pooled CLIP image embedder (condition.py:141-176) ------------------------


class PooledCLIPImageEncoder(nn.Module):
    """Images (b, h, w, 3) in [-1, 1] -> (b, output_dim): CLIP
    preprocessing, the open_clip visual tower, ln_post on the cls token,
    the projection; with ucg_rate > 0, whole samples zeroed with that
    probability (condition.py:170-174)."""

    def __init__(self, cfg: CLIPVisionConfig, output_dim: int = 1024,
                 ucg_rate: float = 0.0):
        super().__init__()
        self.cfg, self.ucg_rate = cfg, ucg_rate
        self.visual = CLIPVisionEncoder(cfg)
        self.ln_post = LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.empty(cfg.width, output_dim))

    def forward(self, images: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                no_dropout: bool = False) -> torch.Tensor:
        images = images.to(self.proj.device, self.proj.dtype)
        x = clip_preprocess((images + 1.0) / 2.0, size=self.cfg.image_size)
        cls = self.ln_post(self.visual(x)[:, 0])
        out = cls @ self.proj.to(cls.dtype)
        if self.ucg_rate > 0.0 and not no_dropout:
            _need_generator(generator)
            keep = torch.rand((out.shape[0], 1), generator=generator,
                              device=out.device) < 1.0 - self.ucg_rate
            out = out * keep.to(out.dtype)
        return out


class CLIPT5Pair(nn.Module):
    """FrozenCLIPT5Encoder: [clip_z, t5_z]."""

    def __init__(self, clip_cfg: CLIPTextConfig, t5_cfg: T5Config):
        super().__init__()
        self.clip = HFCLIPTextEncoder(clip_cfg)
        self.t5 = T5Encoder(t5_cfg)

    def forward(self, clip_ids: torch.Tensor,
                t5_ids: torch.Tensor) -> List[torch.Tensor]:
        return [self.clip(clip_ids), self.t5(t5_ids)]
