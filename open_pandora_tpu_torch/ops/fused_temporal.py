"""Fused temporal self-attention block, y + to_out(attn_t(LN(y))): the CUDA
kernel (csrc/fused_temporal_attn.cu), its plain version, and the wrapper
that picks between them by device.

Counterpart of open_pandora_tpu/ops/fused_temporal.py (Pallas `_kernel`,
through `fused_temporal_self_attention` on a (B, t, c) stream and
`fused_temporal_self_attention_native` on the UNet's native (b, t, hw, c)
stream). One wrapper takes both: a 3-D y is the case hw = 1, and the
kernel reads either through its strides, so the native stream is never
transposed. Weights are nn.Linear's (out, in) matrices, as the model holds
them.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.utils import profiling

MAX_T = 32
MAX_DIM_INNER = 640 * 1280
_HEAD_DIMS = (16, 32, 64)


def fused_temporal_eligible(t: int, dim: int, inner: int,
                            heads: Optional[int] = None) -> bool:
    """The shape half of the JAX gate `_fused_temporal_ok`
    (models/unet3d.py:375-384): t <= 32 and dim * inner <= 640 * 1280. The
    bound keeps the 1280-channel sites on the small-attention kernel, as on
    the JAX route. One rule more than the JAX gate, applied when `heads` is
    given: the kernel's mma tiles serve head widths 16, 32 and 64 and
    channel counts that are multiples of 32, so any other width (48, 80)
    takes the unfused route by its shape."""
    if not (t <= MAX_T and dim * inner <= MAX_DIM_INNER):
        return False
    return heads is None or (heads > 0 and inner % heads == 0
                             and inner // heads in _HEAD_DIMS
                             and dim % 32 == 0)


# c = 64 heads of the tensor-core kernel: each consumer warpgroup's
# out-projection columns (c in 128-row blocks at c <= 320, else c / 2 in
# 64-row blocks, which need an even head count) split into equal blocks of
# 128, 160 or 192, and the R x c tiles leave shared memory for two ring slots
_TC_WIDTHS = (128, 192, 256, 320, 384, 512, 640)


def tensor_core_route(y: torch.Tensor, ln_w: torch.Tensor,
                      ln_b: torch.Tensor, heads: int) -> bool:
    """Whether a launch runs the wgmma kernel (csrc/fused_temporal_attn.cu
    `fused_temporal_tc_kernel`, which the C launcher refuses for any other
    shape): t = 16, head width 64, c in _TC_WIDTHS, and y's rows and the LN
    affine 16-byte aligned. Every other launch runs the mma.sync kernel."""
    t, c = y.shape[1], y.shape[-1]
    return (t == 16 and c == 64 * heads and c in _TC_WIDTHS
            and y.data_ptr() % 16 == 0
            and all(s % 8 == 0 for s in y.stride()[:-1])
            and ln_w.data_ptr() % 16 == 0 and ln_b.data_ptr() % 16 == 0)


def fused_temporal_plain(y: torch.Tensor, wq: torch.Tensor,
                         wk: torch.Tensor, wv: torch.Tensor,
                         wo: torch.Tensor, bo: torch.Tensor,
                         ln_w: torch.Tensor, ln_b: torch.Tensor, *,
                         heads: int, eps: float = 1e-5) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its casts: LN with fp32
    statistics, cast to y's dtype; q, k, v accumulated in fp32, cast; fp32
    scores, softmax normalised, then cast; P V in fp32, cast; the output
    projection in fp32 plus the bias plus the residual in fp32; one cast at
    the end. Scores are scaled by dh ** -0.5."""
    dt = y.dtype
    yt = y.movedim(1, -2) if y.ndim == 4 else y       # (..., t, c)
    c = yt.shape[-1]
    dh = c // heads
    scale = dh ** -0.5
    yf = yt.float()
    mu = yf.mean(dim=-1, keepdim=True)
    var = (yf - mu).square().mean(dim=-1, keepdim=True)
    xn = ((yf - mu) / torch.sqrt(var + eps) * ln_w.float()
          + ln_b.float()).to(dt).float()

    def heads_of(w):                                   # (..., heads, t, dh)
        z = F.linear(xn, w.float()).to(dt).float()
        return z.unflatten(-1, (heads, dh)).transpose(-3, -2)

    q, k, v = heads_of(wq), heads_of(wk), heads_of(wv)
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    attn = (p.to(dt).float() @ v).to(dt).float()
    attn = attn.transpose(-3, -2).flatten(-2)          # (..., t, c)
    out = yf + (F.linear(attn, wo.float()) + bo.float())
    out = out.to(dt)
    return out.movedim(-2, 1) if y.ndim == 4 else out


def fused_temporal_self_attention(y: torch.Tensor, wq: torch.Tensor,
                                  wk: torch.Tensor, wv: torch.Tensor,
                                  wo: torch.Tensor, bo: torch.Tensor,
                                  ln_w: torch.Tensor, ln_b: torch.Tensor, *,
                                  heads: int, eps: float = 1e-5
                                  ) -> torch.Tensor:
    """y + to_out(attn(LN(y))), self-attention over the t axis of y
    (B, t, c) or (b, t, hw, c); wq, wk, wv, wo (c, c) as (out, in), bo,
    ln_w, ln_b (c,). A CUDA tensor launches the kernel; a CPU tensor takes
    the plain version."""
    if y.device.type == "cpu":
        return fused_temporal_plain(y, wq, wk, wv, wo, bo, ln_w, ln_b,
                                    heads=heads, eps=eps)
    return _fused_temporal_cuda(y, wq, wk, wv, wo, bo, ln_w, ln_b,
                                heads=heads, eps=eps)


fused_temporal_self_attention.launches = 0


def check_shapes(y: torch.Tensor, params, heads: int) -> None:
    """What the kernel takes, device aside: bf16 y (B, t, c) or
    (b, t, hw, c) with t <= 32, c = heads * dh, dh in (16, 32, 64),
    c % 32 == 0, c <= 1024; bf16 params (wq, wk, wv, wo (c, c), bo, ln_w,
    ln_b (c,)); wq, wk, wv with one row stride; rows 4-byte aligned, weight
    rows 16-byte aligned."""
    name = "fused_temporal_self_attention"
    wq, wk, wv, wo, bo, ln_w, ln_b = params
    if y.dtype != torch.bfloat16 or any(p.dtype != y.dtype for p in params):
        raise ValueError(f"{name}: needs bf16 y and weights, got {y.dtype}/"
                         f"{[p.dtype for p in params]}")
    if y.ndim not in (3, 4) or y.numel() == 0:
        raise ValueError(f"{name}: y must be (B, t, c) or (b, t, hw, c), got "
                         f"{tuple(y.shape)}")
    t, c = y.shape[1], y.shape[-1]
    dh = c // heads if heads > 0 and c % heads == 0 else 0
    if dh not in _HEAD_DIMS or t > MAX_T or c % 32 or c > 1024:
        raise ValueError(f"{name}: needs c = heads * dh with dh in "
                         f"{_HEAD_DIMS}, c % 32 == 0, c <= 1024 and t <= "
                         f"{MAX_T}; got c={c}, heads={heads}, t={t}")
    if any(w.shape != (c, c) for w in (wq, wk, wv, wo)) or any(
            p.shape != (c,) for p in (bo, ln_w, ln_b)):
        raise ValueError(f"{name}: weights must be (c, c) and vectors (c,)")
    if len({wq.stride(0), wk.stride(0), wv.stride(0)}) != 1:
        raise ValueError(f"{name}: wq, wk, wv must share one row stride")
    kernels.check_aligned(name, y, 4)
    for w in (wq, wk, wv, wo):
        kernels.check_aligned(name, w, 16)
    for p in (bo, ln_w, ln_b):
        kernels.check_aligned(name, p, 4)


def _fused_temporal_cuda(y, wq, wk, wv, wo, bo, ln_w, ln_b, *, heads, eps):
    params = (wq, wk, wv, wo, bo, ln_w, ln_b)
    kernels.check_cuda_tensors("fused_temporal_self_attention", y, *params)
    check_shapes(y, params, heads)
    b, t, c = y.shape[0], y.shape[1], y.shape[-1]
    hw = y.shape[2] if y.ndim == 4 else 1
    dh = c // heads
    ys = y.stride() if y.ndim == 4 else (*y.stride()[:2], 0, 1)
    o = torch.empty_like(y, memory_format=torch.contiguous_format)
    os_ = o.stride() if o.ndim == 4 else (*o.stride()[:2], 0, 1)
    with torch.cuda.device(y.device):
        err = kernels.library().pandora_fused_temporal_attn(
            y.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
            o.data_ptr(), b, t, hw, c, heads,
            int(tensor_core_route(y, ln_w, ln_b, heads)), *ys[:3], *os_[:3],
            wq.stride(0), wo.stride(0), dh ** -0.5, float(eps),
            kernels.DTYPE_CODES[y.dtype], kernels.stream_handle(y))
    kernels.check_cuda(err, "pandora_fused_temporal_attn")
    fused_temporal_self_attention.launches += 1
    if profiling.recording():
        profiling.count("fused_temporal", (
            b, t, hw, c, heads, str(y.dtype).removeprefix("torch.")))
    return o
