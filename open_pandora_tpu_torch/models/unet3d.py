"""DynamiCrafter UNet3D, channel-last: the spatial stream is (b*t, h, w, c),
the temporal stream (b, t, h*w, c) on the fused route and (b*h*w, t, c)
elsewhere.

Counterpart of open_pandora_tpu/models/unet3d.py, with its two routes:
  - fused (bf16, eval, `kernels.fused_available(x)`: a CUDA device, as the
    JAX package's default route asks for a TPU): every GroupNorm takes the
    GroupNorm+SiLU kernel; the spatial attn1 and the dual text + image attn2
    at 2560 and 640 tokens take the packed attention kernel on the packed
    (b, n, h*d) projections; the temporal transformers up to 640 channels
    run attn1 and attn2 each as one fused temporal kernel on the native
    stream; the 1280-channel temporal sites take the small-attention kernel.
  - unfused (fp32, training, or a CPU tensor; the JAX package's route off
    the TPU or with PANDORA_DISABLE_FUSED): every attention goes through
    the dispatcher (flash at 2560 and 640 tokens and small attention at
    t = 16 on a CUDA device), every norm through the plain fp32-statistics
    GroupNorm/LayerNorm.
In training mode (`module.training`, JAX's `deterministic=False`) the
unfused route adds dropout at the JAX sites (attention out-projections, the
GEGLU feed-forward and the ResBlocks at `cfg.dropout`, the temporal conv
blocks at 0.1) and, with `cfg.use_checkpoint`, recomputes every ResBlock,
SpatialTransformer and TemporalTransformer in the backward
(torch.utils.checkpoint, the JAX package's nn.remat). Dropout draws from
the global RNG, whose state the checkpoint saves and restores, so the
recomputed masks are the forward's.
Module and parameter names follow the reference state dict
(`input_blocks.1.0.in_layers.0.weight`, `...transformer_blocks.0.attn2.to_k_ip`,
`temopral_conv` with the reference's spelling); both routes read the same
parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from open_pandora_tpu_torch.core.config import UNet3DConfig
from open_pandora_tpu_torch.diffusion.schedule import timestep_embedding
from open_pandora_tpu_torch.models.layers import (Conv2d, GroupNorm32,
                                                  LayerNorm, PointwiseConv,
                                                  nearest_up2)
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.attention import attention
from open_pandora_tpu_torch.ops.attention_xla import causal_mask
from open_pandora_tpu_torch.ops.fused_temporal import (
    fused_temporal_eligible, fused_temporal_self_attention)
from open_pandora_tpu_torch.ops.packed_attention import (
    dual_cross_attention_packed, packed_attention_eligible,
    self_attention_packed)


def _fused_route(module: nn.Module, x: torch.Tensor) -> bool:
    """The JAX fast paths' common gate: bf16 activations, eval (JAX's
    `deterministic`), and a device the fused kernels serve."""
    return (not module.training and x.dtype == torch.bfloat16
            and kernels.fused_available(x))


def fused_temporal_ok(module: nn.Module, x: torch.Tensor, t: int, dim: int,
                      inner: int) -> bool:
    """`_fused_temporal_ok` (models/unet3d.py:375-384): the fused route and
    the fused temporal kernel's shape gate."""
    return _fused_route(module, x) and fused_temporal_eligible(t, dim, inner)


class CrossAttention(nn.Module):
    """context=None -> self-attention. With image_cross_attention and a
    context, the context splits into [text | image] tokens, each with its
    own key/value projections; the two attentions are summed, the image one
    scaled by the gate (1, or tanh(alpha) + 1 when learnable)."""

    def __init__(self, query_dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_ca_scale_learnable: bool = False,
                 text_context_len: int = 77, dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = context_dim or query_dim
        self.heads, self.dim_head = heads, dim_head
        self.image_cross_attention = image_cross_attention
        self.text_context_len = text_context_len
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim),
                                     nn.Dropout(dropout)])
        if image_cross_attention:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)
            if image_ca_scale_learnable:
                self.alpha = nn.Parameter(torch.zeros(()))

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        return t.view(t.shape[0], t.shape[1], self.heads, self.dim_head)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, _ = x.shape
        q = self.to_q(x)
        inner = q.shape[-1]
        fast = _fused_route(self, x)
        if self.image_cross_attention and context is not None:
            ctx_text = context[:, :self.text_context_len]
            ctx_img = context[:, self.text_context_len:]
            k, v = self.to_k(ctx_text), self.to_v(ctx_text)
            k_ip, v_ip = self.to_k_ip(ctx_img), self.to_v_ip(ctx_img)
            gate = (torch.tanh(self.alpha) + 1.0 if hasattr(self, "alpha")
                    else 1.0)
            if fast and packed_attention_eligible(
                    n, (k.shape[1], k_ip.shape[1]), self.heads, inner):
                # packed attention kernel, both streams and the gate in one
                out = dual_cross_attention_packed(q, k, v, k_ip, v_ip, gate,
                                                  heads=self.heads)
            else:
                qh = self._heads(q)
                out = attention(qh, self._heads(k), self._heads(v))
                out_ip = attention(qh, self._heads(k_ip), self._heads(v_ip))
                out = out + gate * out_ip
        else:
            ctx = x if context is None else context[:, :self.text_context_len]
            k, v = self.to_k(ctx), self.to_v(ctx)
            if fast and mask is None and packed_attention_eligible(
                    n, (k.shape[1],), self.heads, inner):
                # packed attention kernel
                out = self_attention_packed(q, k, v, heads=self.heads)
            else:
                out = attention(self._heads(q), self._heads(k),
                                self._heads(v), mask=mask)
        return self.to_out[1](self.to_out[0](out.reshape(b, n, -1)))


class GEGLU(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    """GEGLU feed-forward: net.0 (GEGLU), net.1 (dropout), net.2 (Linear)."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(dropout),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[1](self.net[0](x)))


class BasicTransformerBlock(nn.Module):
    """pre-LN self-attention -> cross-attention -> GEGLU feed-forward. With
    no context, attn2 self-attends on norm2(x). With `fused_temporal` (the
    temporal sites), no context and no mask, on the fused route, attn1 and
    attn2 each run as one fused temporal kernel (LN, q/k/v, attention over
    t, out-projection, residual) on x of (B, t, c) or the native
    (b, t, hw, c); the feed-forward is row-order agnostic."""

    def __init__(self, dim: int, heads: int, dim_head: int,
                 context_dim: Optional[int] = None,
                 image_cross_attention: bool = False,
                 image_ca_scale_learnable: bool = False,
                 text_context_len: int = 77, fused_temporal: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.fused_temporal = fused_temporal
        self.attn1 = CrossAttention(dim, heads, dim_head, dropout=dropout)
        self.attn2 = CrossAttention(
            dim, heads, dim_head, context_dim=context_dim,
            image_cross_attention=image_cross_attention,
            image_ca_scale_learnable=image_ca_scale_learnable,
            text_context_len=text_context_len, dropout=dropout)
        self.ff = FeedForward(dim, dropout=dropout)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                self_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a1 = self.attn1
        if (self.fused_temporal and context is None and self_mask is None
                and fused_temporal_ok(self, x, x.shape[1], x.shape[-1],
                                      a1.heads * a1.dim_head)):
            for attn, norm in ((self.attn1, self.norm1),
                               (self.attn2, self.norm2)):
                x = fused_temporal_self_attention(
                    x, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
                    attn.to_out[0].weight, attn.to_out[0].bias, norm.weight,
                    norm.bias, heads=attn.heads, eps=norm.eps)
        else:
            x = x + self.attn1(self.norm1(x), None, mask=self_mask)
            x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """Transformer over the h*w tokens of each frame (use_linear)."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 context_dim: int, image_cross_attention: bool,
                 image_ca_scale_learnable: bool, text_context_len: int,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm32(ch, 1e-6)
        self.proj_in = nn.Linear(ch, inner)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(
                inner, heads, dim_head, context_dim=context_dim,
                image_cross_attention=image_cross_attention,
                image_ca_scale_learnable=image_ca_scale_learnable,
                text_context_len=text_context_len, dropout=dropout)
            for _ in range(depth))
        self.proj_out = nn.Linear(inner, ch)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        bt, h, w, c = x.shape
        # bf16 eval on a CUDA device: the GroupNorm+SiLU kernel
        y = self.proj_in(self.norm(x).reshape(bt, h * w, c))
        for blk in self.transformer_blocks:
            y = blk(y, context)
        return x + self.proj_out(y).reshape(bt, h, w, c)


class TemporalTransformer(nn.Module):
    """Self-attention over the t axis of every spatial position.
    use_linear=False keeps the reference's Conv1d(k=1) weight shape for
    proj_in/proj_out (init_attn). Where its blocks take the fused temporal
    kernel, the stream stays in the native (b, t, h*w, c) layout (proj_in,
    LN and the feed-forward are row-order agnostic, and the kernel reads
    the positions through strides); elsewhere it is transposed to
    (b*h*w, t, c)."""

    def __init__(self, ch: int, heads: int, dim_head: int, depth: int,
                 causal: bool = False, use_linear: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        inner = heads * dim_head
        self.causal = causal
        self.norm = GroupNorm32(ch, 1e-6)
        if use_linear:
            self.proj_in = nn.Linear(ch, inner)
            self.proj_out = nn.Linear(inner, ch)
        else:
            self.proj_in = PointwiseConv(ch, inner, spatial_dims=1)
            self.proj_out = PointwiseConv(inner, ch, spatial_dims=1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(inner, heads, dim_head,
                                  fused_temporal=not causal, dropout=dropout)
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        blk0 = self.transformer_blocks[0].attn1
        inner = blk0.heads * blk0.dim_head
        y = self.norm(x)
        # The JAX package stays native only where h*w % 32 == 0 (its
        # kernel's position tile); the port's kernel takes a ragged last
        # tile, so every fused site stays native. Row order does not change
        # the result.
        native = not self.causal and fused_temporal_ok(self, y, t, inner,
                                                       inner)
        if native:
            y = y.reshape(b, t, h * w, c)
        else:
            y = y.permute(0, 2, 3, 1, 4).reshape(b * h * w, t, c)
        y = self.proj_in(y)
        mask = causal_mask(t, t, x.device) if self.causal else None
        for blk in self.transformer_blocks:
            # the fused temporal kernel where c * inner <= 640 * 1280, else
            # attn1 and attn2 take the small-attention kernel on a CUDA
            # device
            y = blk(y, None, self_mask=mask)
        y = self.proj_out(y)
        if native:
            return x + y.reshape(b, t, h, w, c)
        return x + y.reshape(b, h, w, t, c).permute(0, 3, 1, 2, 4)


class TConv3(nn.Module):
    """Conv3d with kernel (3, 1, 1) and padding (1, 0, 0) over
    (b, t, h, w, c), as three shifted matmuls over the t axis."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(ch, ch, 3, 1, 1))
        self.bias = nn.Parameter(torch.empty(ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        w = self.weight[:, :, :, 0, 0]
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
        y = (F.linear(xp[:, :t], w[..., 0]) + F.linear(xp[:, 1:t + 1], w[..., 1])
             + F.linear(xp[:, 2:t + 2], w[..., 2]))
        return y + self.bias


class TemporalConvBlock(nn.Module):
    """4 x (GN + SiLU [+ dropout 0.1, as the JAX package hard-codes it, in
    conv2-4] + TConv3), residual."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv1 = nn.ModuleList([GroupNorm32(ch, 1e-5), nn.SiLU(),
                                    TConv3(ch)])
        for i in (2, 3, 4):
            self.add_module(f"conv{i}", nn.ModuleList([
                GroupNorm32(ch, 1e-5), nn.SiLU(), nn.Dropout(0.1),
                TConv3(ch)]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # bf16 eval on a CUDA device: the GroupNorm+SiLU kernel
        h = self.conv1[2](self.conv1[0](x, silu=True))
        for layers in (self.conv2, self.conv3, self.conv4):
            h = layers[3](layers[2](layers[0](h, silu=True)))
        return x + h


class ResBlock(nn.Module):
    """GN+SiLU+conv, + time embedding, GN+SiLU+conv, skip; then the
    temporal conv block over (b, t, h, w, c)."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_temporal_conv: bool, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(in_ch, 1e-5), nn.SiLU(),
                                        Conv2d(in_ch, out_ch, 3, padding=1)])
        self.emb_layers = nn.ModuleList([nn.SiLU(),
                                         nn.Linear(emb_dim, out_ch)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_ch, 1e-5), nn.SiLU(), nn.Dropout(dropout),
            Conv2d(out_ch, out_ch, 3, padding=1)])
        self.skip_connection = (PointwiseConv(in_ch, out_ch)
                                if in_ch != out_ch else None)
        self.temopral_conv = (TemporalConvBlock(out_ch) if use_temporal_conv
                              else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        # bf16 eval on a CUDA device: the GroupNorm+SiLU kernel, both norms
        h = self.in_layers[2](self.in_layers[0](x, silu=True))
        e = self.emb_layers[1](F.silu(emb))
        h = h + e[:, None, None, :]
        h = self.out_layers[3](self.out_layers[2](
            self.out_layers[0](h, silu=True)))
        if self.skip_connection is not None:
            x = self.skip_connection(x)
        h = x + h
        if self.temopral_conv is not None:
            bt, hh, ww, c = h.shape
            hv = h.reshape(batch_size, bt // batch_size, hh, ww, c)
            h = self.temopral_conv(hv).reshape(bt, hh, ww, c)
        return h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    """Nearest 2x, then a 3x3 conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_up2(x))


class UNetModel(nn.Module):
    """x (b, t, h, w, c_in), timesteps (b,), context (b, L, context_dim),
    fs (b,) -> (b, t, h, w, out_channels)."""

    def __init__(self, cfg: UNet3DConfig):
        super().__init__()
        self.cfg = cfg
        mc = cfg.model_channels
        ted = mc * 4
        self.time_embed = nn.ModuleList([nn.Linear(mc, ted), nn.SiLU(),
                                         nn.Linear(ted, ted)])
        if cfg.fs_condition:
            self.fps_embedding = nn.ModuleList([nn.Linear(mc, ted), nn.SiLU(),
                                                nn.Linear(ted, ted)])

        def res(cin, cout):
            return ResBlock(cin, cout, ted, cfg.temporal_conv, cfg.dropout)

        def spatial(ch):
            return SpatialTransformer(
                ch, ch // cfg.num_head_channels, cfg.num_head_channels,
                cfg.transformer_depth, cfg.context_dim,
                cfg.image_cross_attention,
                cfg.image_cross_attention_scale_learnable,
                cfg.text_context_len, cfg.dropout)

        def temporal(ch, heads=None, use_linear=True):
            heads = heads if heads is not None else ch // cfg.num_head_channels
            return TemporalTransformer(ch, heads, cfg.num_head_channels,
                                       cfg.transformer_depth,
                                       causal=cfg.use_causal_attention,
                                       use_linear=use_linear,
                                       dropout=cfg.dropout)

        inputs = [nn.ModuleList([Conv2d(cfg.in_channels, mc, 3, padding=1)])]
        if cfg.addition_attention:
            self.init_attn = nn.ModuleList([temporal(mc, heads=8,
                                                     use_linear=False)])
        chans, ch, ds = [mc], mc, 1
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                block = [res(ch, mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(spatial(ch))
                    if cfg.temporal_attention:
                        block.append(temporal(ch))
                inputs.append(nn.ModuleList(block))
                chans.append(ch)
            if level != len(cfg.channel_mult) - 1:
                inputs.append(nn.ModuleList([Downsample(ch)]))
                chans.append(ch)
                ds *= 2
        self.input_blocks = nn.ModuleList(inputs)

        middle = [res(ch, ch), spatial(ch)]
        if cfg.temporal_attention:
            middle.append(temporal(ch))
        middle.append(res(ch, ch))
        self.middle_block = nn.ModuleList(middle)

        outputs = []
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                block = [res(ch + chans.pop(), mult * mc)]
                ch = mult * mc
                if ds in cfg.attention_resolutions:
                    block.append(spatial(ch))
                    if cfg.temporal_attention:
                        block.append(temporal(ch))
                if level and i == cfg.num_res_blocks:
                    block.append(Upsample(ch))
                    ds //= 2
                outputs.append(nn.ModuleList(block))
        self.output_blocks = nn.ModuleList(outputs)
        self.out = nn.ModuleList([GroupNorm32(ch, 1e-5), nn.SiLU(),
                                  Conv2d(ch, cfg.out_channels, 3, padding=1)])

    def _embed(self, layers: nn.ModuleList, steps: torch.Tensor,
               dtype) -> torch.Tensor:
        e = timestep_embedding(steps, self.cfg.model_channels).to(dtype)
        return layers[2](F.silu(layers[0](e)))

    def _run(self, block: nn.ModuleList, h: torch.Tensor, emb: torch.Tensor,
             ctx: torch.Tensor, b: int) -> torch.Tensor:
        # gradient checkpointing in training (the reference's checkpoint
        # wrapper, common.py:81-94; the JAX package's nn.remat)
        remat = (self.training and self.cfg.use_checkpoint
                 and torch.is_grad_enabled())

        def call(layer, *args):
            if remat:
                return torch.utils.checkpoint.checkpoint(
                    layer, *args, use_reentrant=False)
            return layer(*args)

        for layer in block:
            if isinstance(layer, ResBlock):
                h = call(layer, h, emb, b)
            elif isinstance(layer, SpatialTransformer):
                h = call(layer, h, ctx)
            elif isinstance(layer, TemporalTransformer):
                bt, sh, sw, c = h.shape
                h = call(layer, h.reshape(b, bt // b, sh, sw, c)
                         ).reshape(h.shape)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                fs: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, hh, ww, _ = x.shape
        dtype = self.out[2].weight.dtype

        emb = self._embed(self.time_embed, timesteps, dtype)
        if cfg.fs_condition:
            if fs is None:
                fs = torch.full((b,), cfg.default_fs, dtype=torch.int64,
                                device=x.device)
            emb = emb + self._embed(self.fps_embedding, fs, dtype)

        # context: [text | per-frame image tokens]
        if context.shape[1] == cfg.text_context_len + t * cfg.img_tokens_per_frame:
            ctx_text = context[:, :cfg.text_context_len].repeat_interleave(
                t, dim=0)
            ctx_img = context[:, cfg.text_context_len:].reshape(
                b * t, cfg.img_tokens_per_frame, -1)
            ctx = torch.cat([ctx_text, ctx_img], dim=1)
        else:
            ctx = context.repeat_interleave(t, dim=0)
        ctx = ctx.to(dtype)
        emb_bt = emb.repeat_interleave(t, dim=0)

        h = x.reshape(b * t, hh, ww, x.shape[-1]).to(dtype)
        h = self.input_blocks[0][0](h)
        if cfg.addition_attention:
            h = self._run(self.init_attn, h, emb_bt, ctx, b)
        hs = [h]
        for block in self.input_blocks[1:]:
            h = self._run(block, h, emb_bt, ctx, b)
            hs.append(h)
        h = self._run(self.middle_block, h, emb_bt, ctx, b)
        for block in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=-1)
            h = self._run(block, h, emb_bt, ctx, b)
        y = self.out[2](self.out[0](h, silu=True))
        return y.reshape(b, t, hh, ww, cfg.out_channels).to(x.dtype)
