"""DynamiCrafter UNet3D, channel-last: the spatial stream is (b*t, h, w, c),
the temporal stream (b, t, h*w, c) on the fused route and (b*h*w, t, c)
elsewhere.

Counterpart of open_pandora_tpu/models/unet3d.py, with its two routes:
  - fused (bf16, eval, `kernels.fused_available(x)`: a CUDA device, as the
    JAX package's default route asks for a TPU): every GroupNorm takes the
    GroupNorm+SiLU kernel; the spatial attn1 and the dual text + image attn2
    at 512 tokens or more take the packed attention kernel on the packed
    (b, n, h*d) projections (attn2 the dual cross-attention kernel where the
    head width does not divide 128); the temporal transformers up to 640
    channels with heads 16, 32 or 64 wide run attn1 and attn2 each as one
    fused temporal kernel on the native stream; the other temporal sites
    take the small-attention kernel; every transformer block's LN3 ->
    GEGLU -> Linear -> residual is one call of the fused GEGLU feed-forward
    kernel (row 13), a route the JAX package does not take (its Pallas
    kernel lost to XLA on the TPU; the Hopper kernels win on the H100).
  - unfused (fp32, training, a CPU tensor, or PANDORA_DISABLE_FUSED, as
    the JAX package's route off the TPU or under that flag; the finer
    switches PANDORA_DISABLE_PACKED, _DUALCA, _FUSED_GN and _TNATIVE of
    core/flags.py turn one kernel off each): every attention goes through
    the dispatcher (flash at 2560 and 640 tokens and small attention at
    t = 16 on a CUDA device), every norm through the plain fp32-statistics
    GroupNorm/LayerNorm.
Independently of those two, the JAX package's opt-in conv routes
(core/flags.py; eval with `kernels.fused_available(x)`, any dtype): under
PANDORA_ENABLE_PCONV2 the eligible ResBlock convs take the fused conv kernel
with GroupNorm(+emb)+SiLU folded into its prologue and the skip into its
epilogue, and the input and Upsample convs the same kernel without them;
under PANDORA_ENABLE_PCONV those convs take the direct conv kernel. The
output conv and the stride-2 Downsample stay library convolutions.
In training mode (`module.training`, JAX's `deterministic=False`) the
unfused route adds dropout at the JAX sites (attention out-projections, the
GEGLU feed-forward and the ResBlocks at `cfg.dropout`, the temporal conv
blocks at 0.1) and, with `cfg.use_checkpoint`, recomputes every ResBlock,
SpatialTransformer and TemporalTransformer in the backward
(torch.utils.checkpoint, the JAX package's nn.remat), and under
PANDORA_FINE_REMAT also each transformer block's attn1, attn2 and
feed-forward on its own inside that. Dropout draws from the global RNG,
whose state the checkpoint saves and restores, so the recomputed masks are
the forward's. Off the fused route, in either mode, the feed-forward runs
in chunks of its leading axis where its intermediate exceeds 256M elements
(576x1024).
Module and parameter names follow the reference state dict
(`input_blocks.1.0.in_layers.0.weight`, `...transformer_blocks.0.attn2.to_k_ip`,
`temopral_conv` with the reference's spelling); both routes read the same
parameters.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.core.config import UNet3DConfig
from open_pandora_tpu_torch.diffusion.schedule import timestep_embedding
from open_pandora_tpu_torch.models.layers import (Conv2d, GroupNorm32,
                                                  LayerNorm, PointwiseConv,
                                                  SConv3x3, TConv3,
                                                  nearest_up2)
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops.attention import attention
from open_pandora_tpu_torch.ops.attention_xla import causal_mask
from open_pandora_tpu_torch.ops.conv2d import conv3x3_fused_eligible
from open_pandora_tpu_torch.ops.dual_cross_attention import (
    dual_cross_attention, dual_cross_attention_eligible)
from open_pandora_tpu_torch.ops.fused_geglu import (fused_geglu_ff,
                                                    geglu_ff_eligible)
from open_pandora_tpu_torch.ops.fused_temporal import (
    fused_temporal_eligible, fused_temporal_self_attention)
from open_pandora_tpu_torch.ops.packed_attention import (
    dual_cross_attention_packed, packed_attention_eligible,
    self_attention_packed)
from open_pandora_tpu_torch.utils.profiling import span


def _fused_route(module: nn.Module, x: torch.Tensor) -> bool:
    """The JAX fast paths' common gate: bf16 activations, eval (JAX's
    `deterministic`), a device the fused kernels serve, and no
    PANDORA_DISABLE_FUSED (`_fused_available`, models/unet3d.py:387-398)."""
    return (not module.training and x.dtype == torch.bfloat16
            and kernels.fused_available(x)
            and not flags.flag("PANDORA_DISABLE_FUSED"))


def fused_temporal_ok(module: nn.Module, x: torch.Tensor, t: int, dim: int,
                      inner: int, heads: Optional[int] = None) -> bool:
    """`_fused_temporal_ok` (models/unet3d.py:375-384): the fused route and
    the fused temporal kernel's shape gate (with `heads`, its head-width
    rule too)."""
    return _fused_route(module, x) and fused_temporal_eligible(t, dim, inner,
                                                               heads)


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
            elif fast and dual_cross_attention_eligible(
                    n, k.shape[1], k_ip.shape[1], self.dim_head):
                # head widths the packed gate refuses (not a divisor of
                # 128): the dual cross-attention kernel on head views
                out = dual_cross_attention(
                    self._heads(q), self._heads(k), self._heads(v),
                    self._heads(k_ip), self._heads(v_ip), gate)
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
    """GEGLU feed-forward: net.0 (GEGLU), net.1 (dropout), net.2 (Linear).

    Where the GEGLU intermediate (the tokens times 2 * mult * dim) exceeds
    CHUNK_THRESHOLD elements, the leading axis is processed in chunks that
    share the weights: the count doubles from 2 while a chunk holds more
    than CHUNK_TARGET elements and the axis stays divisible, and an axis
    that 2 does not divide is not chunked (JAX models/unet3d.py:239-271).
    At 576x1024 the level-0 sites take 4 chunks in training and 8 in the
    CFG eval. With `remat` each chunk is recomputed in the backward on its
    own (the whole feed-forward when it is not chunked), so the backward
    holds one chunk's intermediate at a time. The fused route does not
    call forward: `kernel_weights` gives the fused GEGLU kernel the same
    parameters."""

    CHUNK_THRESHOLD = 256 * 2 ** 20
    CHUNK_TARGET = 128 * 2 ** 20

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * mult), nn.Dropout(dropout),
                                  nn.Linear(dim * mult, dim)])
        self._packed = None

    def kernel_weights(self, dtype: torch.dtype):
        """(w1, b1, w2, b2) in the fused GEGLU kernel's layout: w1 (dim,
        2 inner) with the value columns first (GEGLU's chunk order), w2
        (inner, dim). Derived once per dtype and device and kept until a
        parameter changes (its version counter or storage)."""
        params = (self.net[0].proj.weight, self.net[0].proj.bias,
                  self.net[2].weight, self.net[2].bias)
        key = (tuple((p._version, p.data_ptr()) for p in params),
               params[0].device, dtype)
        if self._packed is None or self._packed[0] != key:
            with torch.no_grad():
                w1, b1, w2, b2 = (p.detach().to(dtype) for p in params)
                packed = (w1.t().contiguous(), b1, w2.t().contiguous(), b2)
            self._packed = (key, packed)
        return self._packed[1]

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[1](self.net[0](x)))

    def chunks(self, shape) -> int:
        """How many pieces the leading axis of an input of `shape` is
        processed in."""
        n = shape[0]
        elems = math.prod(shape[:-1]) * self.net[2].in_features * 2
        if elems <= self.CHUNK_THRESHOLD or n % 2:
            return 1
        chunks = 2
        while elems // chunks > self.CHUNK_TARGET and n % (chunks * 2) == 0:
            chunks *= 2
        return chunks

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        def ff(part):
            if remat:
                return torch.utils.checkpoint.checkpoint(
                    self._ff, part, use_reentrant=False)
            return self._ff(part)

        chunks = self.chunks(x.shape)
        if chunks == 1:
            return ff(x)
        return torch.cat([ff(part) for part in x.chunk(chunks)], dim=0)


def geglu_residual(module: nn.Module, x: torch.Tensor, norm: LayerNorm,
                   ff: FeedForward, remat: bool = False) -> torch.Tensor:
    """x + ff(norm(x)). On `module`'s fused route, where the kernel takes
    the width, one call of the fused GEGLU kernel (LN, up-projection,
    GEGLU, down-projection, residual) over all rows, unchunked; elsewhere
    the eager chain, chunked as FeedForward chunks it."""
    inner = ff.net[2].in_features
    c = x.shape[-1]
    if _fused_route(module, x) and geglu_ff_eligible(c, inner // c):
        return fused_geglu_ff(x, norm.weight, norm.bias,
                              *ff.kernel_weights(x.dtype), eps=norm.eps)
    return x + ff(norm(x), remat=remat)


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

    def feed_forward(self, x: torch.Tensor, remat: bool = False
                     ) -> torch.Tensor:
        """x + ff(norm3(x)) (`geglu_residual`)."""
        return geglu_residual(self, x, self.norm3, self.ff, remat)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None,
                self_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        a1 = self.attn1
        if (self.fused_temporal and context is None and self_mask is None
                and fused_temporal_ok(self, x, x.shape[1], x.shape[-1],
                                      a1.heads * a1.dim_head, a1.heads)):
            for attn, norm in ((self.attn1, self.norm1),
                               (self.attn2, self.norm2)):
                x = fused_temporal_self_attention(
                    x, attn.to_q.weight, attn.to_k.weight, attn.to_v.weight,
                    attn.to_out[0].weight, attn.to_out[0].bias, norm.weight,
                    norm.bias, heads=attn.heads, eps=norm.eps)
            return self.feed_forward(x)
        # PANDORA_FINE_REMAT (training): attn1, attn2 and the feed-forward
        # each recomputed in the backward on its own, inside the block-level
        # checkpoint, so that a block's backward never holds the three
        # modules' temporaries together (JAX models/unet3d.py:322-354)
        fine = (self.training and torch.is_grad_enabled()
                and flags.flag("PANDORA_FINE_REMAT"))

        def call(module, *args):
            if fine:
                return torch.utils.checkpoint.checkpoint(
                    module, *args, use_reentrant=False)
            return module(*args)

        x = x + call(self.attn1, self.norm1(x), None, self_mask)
        x = x + call(self.attn2, self.norm2(x), context)
        return self.feed_forward(x, remat=fine)


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
        # tile, so every fused site stays native unless
        # PANDORA_DISABLE_TNATIVE keeps it on the transposed stream. Row
        # order does not change the result.
        native = (not self.causal
                  and fused_temporal_ok(self, y, t, inner, inner, blk0.heads)
                  and not flags.flag("PANDORA_DISABLE_TNATIVE"))
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
    temporal conv block over (b, t, h, w, c). In eval, where the fused conv
    gate admits a conv (PANDORA_ENABLE_PCONV2; `kernels.fused_available`),
    its GroupNorm(+emb)+SiLU folds into the conv kernel's prologue and the
    skip into its epilogue, as on the JAX route (models/unet3d.py:644-670);
    dropout is the identity there."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int,
                 use_temporal_conv: bool, dropout: float = 0.0):
        super().__init__()
        self.in_layers = nn.ModuleList([GroupNorm32(in_ch, 1e-5), nn.SiLU(),
                                        SConv3x3(in_ch, out_ch)])
        self.emb_layers = nn.ModuleList([nn.SiLU(),
                                         nn.Linear(emb_dim, out_ch)])
        self.out_layers = nn.ModuleList([
            GroupNorm32(out_ch, 1e-5), nn.SiLU(), nn.Dropout(dropout),
            SConv3x3(out_ch, out_ch)])
        self.skip_connection = (PointwiseConv(in_ch, out_ch)
                                if in_ch != out_ch else None)
        self.temopral_conv = (TemporalConvBlock(out_ch) if use_temporal_conv
                              else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor,
                batch_size: int) -> torch.Tensor:
        fast = not self.training
        in_norm, in_conv = self.in_layers[0], self.in_layers[2]
        out_norm, out_conv = self.out_layers[0], self.out_layers[3]

        def fused_route(c_in, c_out):
            return (fast and kernels.fused_available(x)
                    and conv3x3_fused_eligible(x.shape[1], x.shape[2], c_in,
                                               c_out))

        # elsewhere, bf16 eval on a CUDA device: the GroupNorm+SiLU kernel
        out_ch = out_conv.out_channels
        if fused_route(x.shape[-1], out_ch):
            h = in_conv(x, fast=True, prologue=in_norm.fold(x))
        else:
            h = in_conv(in_norm(x, silu=True), fast=fast)
        e = self.emb_layers[1](F.silu(emb))
        if fused_route(out_ch, out_ch):
            skip = (x if self.skip_connection is None
                    else self.skip_connection(x))
            h = out_conv(h, fast=True, prologue=out_norm.fold(h, extra=e),
                         residual=skip)
        else:
            h = h + e[:, None, None, :]
            h = out_conv(self.out_layers[2](out_norm(h, silu=True)),
                         fast=fast)
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
    """Nearest 2x, then a 3x3 conv (the conv routes in eval)."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = SConv3x3(ch, ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(nearest_up2(x), fast=not self.training)


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

        inputs = [nn.ModuleList([SConv3x3(cfg.in_channels, mc)])]
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
        # the output conv stays a plain conv: nn.Conv in the JAX package
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
                with span("unet.resblock"):
                    h = call(layer, h, emb, b)
            elif isinstance(layer, SpatialTransformer):
                with span("unet.spatial"):
                    h = call(layer, h, ctx)
            elif isinstance(layer, TemporalTransformer):
                with span("unet.temporal"):
                    bt, sh, sw, c = h.shape
                    h = call(layer, h.reshape(b, bt // b, sh, sw, c)
                             ).reshape(h.shape)
            else:
                h = layer(h)
        return h

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor,
                fs: Optional[torch.Tensor] = None) -> torch.Tensor:
        with span("unet"):
            return self._forward(x, timesteps, context, fs)

    def _forward(self, x, timesteps, context, fs):
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
        h = self.input_blocks[0][0](h, fast=not self.training)
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
