"""3x3 stride-1 same-padding convolution over channel-last (B, H, W, C): the
CUDA kernel (csrc/conv3x3.cu) in its two forms, their plain versions, the
routing gates and the nine-dot formulation.

Counterpart of open_pandora_tpu/ops/conv2d.py:
  - `conv3x3_nhwc` (row 11, Pallas `_kernel`): conv + bias;
  - `conv3x3_fused` (row 12, Pallas `_fused_kernel`): conv of the folded
    GroupNorm(+emb)+SiLU prologue silu(x * scale + shift), zero-padded in
    the activated domain, + bias + residual;
  - `conv3x3_ninedot`: nine shifted matmuls, plain PyTorch on purpose (plain
    XLA in the JAX package, no Pallas kernel);
  - `conv3x3_eligible` / `conv3x3_fused_eligible`: the JAX gates, which the
    UNet's opt-in routes ask (`PANDORA_ENABLE_PCONV`, `PANDORA_ENABLE_PCONV2`,
    `PANDORA_PCONV_ONLY`, `PANDORA_DISABLE_PCONV`; core/flags.py).

Both wrappers take the JAX signatures (w (3, 3, C, Co), scale and shift
(B, C) fp32) and pick the kernel or the plain version by the tensor's device
alone: a CPU tensor gets the plain version, a CUDA tensor the kernel or an
exception. A caller that holds the weight in the kernel's (Co, 9 C) layout
passes it as `packed` (models/layers.SConv3x3 derives it once per module).

The VMEM model below (`_stack_bytes`, `_choose_blocks`, `_split_point`,
their fused variants, `_LANES` and the budgets) is copied from the JAX
package only as the rule that names which sites route, so that the port
routes exactly the sites the JAX package routes. It never tiles the card's
kernel, and the card has no C-split: the CUDA kernel takes the whole C at
every site, (72, 128, 960 -> 320) included, which the JAX package routes
only as two convolutions over C = 640 and 320 summed in bf16. There the
port's result is the closer to fp32. The JAX package's compile denylist
(`_MOSAIC_DENY`) is a TPU-compiler artefact, empty there, and is left out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.ops import kernels

_STACK_BUDGET = 32.0 * 2**20
_FUSED_BUDGET = 40.0 * 2**20
_LANES = 128
_GRID_Y = 65535

# filled by models/layers.SConv3x3 with every site's (h, w, c, co) when
# PANDORA_CONV_CENSUS is set
CENSUS: set = set()


# -- the JAX gates ------------------------------------------------------------

def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _stack_bytes(h: int, w: int, c: int, co_blk: int, hs: int,
                 co: int) -> int:
    x_slab = (h + 2) * (w + 2) * c * 2
    slice_tmp = 2 * hs * w * c * 2
    acc = hs * w * co_blk * 4
    wgt = 9 * c * co_blk * 2 * (2 if co // co_blk > 1 else 1)
    out = h * w * co_blk * 2
    return x_slab + slice_tmp + acc + wgt + out


def _choose_blocks(h: int, w: int, c: int, co: int):
    co_cands = sorted(
        {d for d in range(_LANES, co + 1, _LANES) if co % d == 0} | {co},
        reverse=True)
    for co_blk in co_cands:
        for n_strips in (1, 2, 4, 8):
            if h % n_strips:
                continue
            if _stack_bytes(h, w, c, co_blk, h // n_strips,
                            co) <= _STACK_BUDGET:
                return co_blk, n_strips
    return None


def _split_point(h: int, w: int, c: int, co: int):
    for p in (640, 512, 384, c // 2):
        q = c - p
        if not (0 < p < c) or p % 8 or q % 8:
            continue
        if _choose_blocks(h, w, p, co) and _choose_blocks(h, w, q, co):
            return p
    return None


def _fused_stack_bytes(h: int, w: int, c: int, co_blk: int, hs: int,
                       co: int, residual: bool) -> int:
    cp = _ceil_to(c, _LANES)
    cop = _ceil_to(co_blk, _LANES)
    slab = (h + 2) * _ceil_to(w + 9, 8) * cp * 2
    wgt = 9 * cp * cop * 2 * 2
    out = hs * w * cop * 2 * 2
    res = hs * w * cop * 2 * 2 if residual else 0
    acc = hs * w * cop * 4
    slice_tmp = 2 * hs * w * cp * 2
    prologue_tmp = hs * w * cp * 4
    return slab + wgt + out + res + acc + slice_tmp + prologue_tmp


def _choose_blocks_fused(h: int, w: int, c: int, co: int,
                         residual: bool = True):
    co_cands = sorted(
        {d for d in range(_LANES, co + 1, _LANES) if co % d == 0} | {co},
        reverse=True)
    for co_blk in co_cands:
        for n_strips in (1, 2, 4, 8, 16):
            if h % n_strips:
                continue
            if _fused_stack_bytes(h, w, c, co_blk, h // n_strips, co,
                                  residual) <= _FUSED_BUDGET:
                return co_blk, n_strips
    return None


def _fused_split_point(h: int, w: int, c: int, co: int):
    for p in (640, 512, 384, c // 2):
        q = c - p
        if not (0 < p < c) or p % 8 or q % 8:
            continue
        if (_choose_blocks_fused(h, w, p, co)
                and _choose_blocks_fused(h, w, q, co, residual=False)):
            return p
    return None


def _flags_admit(h: int, w: int, c: int, co: int, enable: str) -> bool:
    """The flag grammar both JAX gates share: DISABLE vetoes, a non-empty
    PCONV_ONLY whitelist of "HxWxCxCO" replaces the enable flag."""
    if flags.flag("PANDORA_DISABLE_PCONV"):
        return False
    only = flags.flag("PANDORA_PCONV_ONLY")
    if only:
        return f"{h}x{w}x{c}x{co}" in only.split(",")
    return bool(flags.flag(enable))


def conv3x3_eligible(h: int, w: int, c: int, co: int) -> bool:
    """`conv3x3_eligible` (open_pandora_tpu/ops/conv2d.py:112): opt-in under
    PANDORA_ENABLE_PCONV or the PANDORA_PCONV_ONLY whitelist; c and co
    multiples of 8; h * w >= 512; a whole or C-split block plan within the
    JAX package's VMEM model."""
    if not _flags_admit(h, w, c, co, "PANDORA_ENABLE_PCONV"):
        return False
    if c % 8 or co % 8 or h * w < 512:
        return False
    if _choose_blocks(h, w, c, co):
        return True
    return _split_point(h, w, c, co) is not None


def conv3x3_fused_eligible(h: int, w: int, c: int, co: int) -> bool:
    """`conv3x3_fused_eligible` (open_pandora_tpu/ops/conv2d.py:212): opt-in
    under PANDORA_ENABLE_PCONV2 or the whitelist; c, co and w multiples of
    8; h * w >= 512; a whole or C-split plan within the fused VMEM model."""
    if not _flags_admit(h, w, c, co, "PANDORA_ENABLE_PCONV2"):
        return False
    if c % 8 or co % 8 or w % 8 or h * w < 512:
        return False
    if _choose_blocks_fused(h, w, c, co):
        return True
    return _fused_split_point(h, w, c, co) is not None


# -- plain versions -----------------------------------------------------------

def pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(3, 3, C, Co) -> the kernel's (Co, 9 C) in `dtype`, k = (3 ky + kx) C
    + c."""
    co = w.shape[-1]
    return w.permute(3, 0, 1, 2).reshape(co, -1).to(dtype).contiguous()


def conv3x3_fused_plain(x: torch.Tensor, w: torch.Tensor,
                        b: Optional[torch.Tensor] = None,
                        scale: Optional[torch.Tensor] = None,
                        shift: Optional[torch.Tensor] = None,
                        residual: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The fused kernel's function with its casts: silu(x * scale + shift)
    in fp32, rounded to x.dtype (skipped when scale is None); zero padding
    after it; the weight rounded to x.dtype; products accumulated in fp32;
    + bias, + residual (rounded to x.dtype) in fp32; one cast. float64
    inputs stay float64 throughout (the reference the fp32 kernel is held
    to)."""
    dt = x.dtype
    ct = torch.float64 if dt == torch.float64 else torch.float32
    xf = x.to(ct)
    if scale is not None:
        xf = F.silu(xf * scale.to(ct)[:, None, None, :]
                    + shift.to(ct)[:, None, None, :]).to(dt).to(ct)
    wf = w.to(dt).to(ct).permute(3, 2, 0, 1)               # OIHW
    y = F.conv2d(xf.permute(0, 3, 1, 2), wf, padding=1).permute(0, 2, 3, 1)
    if b is not None:
        y = y + b.to(ct)
    if residual is not None:
        y = y + residual.to(dt).to(ct)
    return y.to(dt)


def conv3x3_nhwc_plain(x: torch.Tensor, w: torch.Tensor,
                       b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The direct kernel's function: conv + bias, fp32 accumulation, out in
    x.dtype."""
    return conv3x3_fused_plain(x, w, b)


def conv3x3_ninedot(x: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The same convolution as nine shifted full-stream matmuls over the
    padded input, in x.dtype (the JAX package's `conv3x3_ninedot`, routed
    under PANDORA_SPATIAL_DOT)."""
    hh, ww = x.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    wb = w.to(x.dtype)
    y = None
    for dy in range(3):
        for dx in range(3):
            tap = F.linear(xp[:, dy:dy + hh, dx:dx + ww, :], wb[dy, dx].t())
            y = tap if y is None else y + tap
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# -- the kernel wrappers ------------------------------------------------------

def check_shapes(name: str, x: torch.Tensor, packed: torch.Tensor,
                 scale: Optional[torch.Tensor] = None,
                 shift: Optional[torch.Tensor] = None,
                 residual: Optional[torch.Tensor] = None) -> None:
    """What the kernel takes, device aside: x (B, H, W, C) fp32 or bf16,
    contiguous and 16-byte aligned; C and Co multiples of 8; the (Co, 9 C)
    weight contiguous in x.dtype; scale and shift both or neither, (B, C)
    fp32 contiguous; residual (B, H, W, Co) contiguous in x.dtype; the
    grid's extents within the card's limits."""
    if x.dtype not in kernels.DTYPE_CODES or x.ndim != 4:
        raise ValueError(f"{name}: needs fp32 or bf16 (B, H, W, C), got "
                         f"{x.dtype} {tuple(x.shape)}")
    bsz, h, w, c = x.shape
    co = packed.shape[0]
    if (x.numel() == 0 or c % 8 or co % 8 or packed.shape != (co, 9 * c)
            or packed.dtype != x.dtype):
        raise ValueError(f"{name}: bad shapes {tuple(x.shape)}, weight "
                         f"{tuple(packed.shape)} {packed.dtype} (C % 8 == 0, "
                         "Co % 8 == 0)")
    if -(-bsz * h * w // 64) >= 2**31 or -(-co // 64) > _GRID_Y:
        raise ValueError(f"{name}: {bsz * h * w} pixels x {co} channels "
                         "exceed the grid")
    if (scale is None) != (shift is None):
        raise ValueError(f"{name}: scale and shift go together")
    for t, shape, dt in ((scale, (bsz, c), torch.float32),
                         (shift, (bsz, c), torch.float32),
                         (residual, (bsz, h, w, co), x.dtype)):
        if t is not None and (t.shape != shape or t.dtype != dt
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: expected {shape} {dt} contiguous, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for t in (x, packed, scale, shift, residual):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: tensors must be contiguous and "
                             "16-byte aligned")


def _conv_cuda(x: torch.Tensor, packed: torch.Tensor,
               b: Optional[torch.Tensor], scale: Optional[torch.Tensor],
               shift: Optional[torch.Tensor],
               residual: Optional[torch.Tensor], *, fused: bool
               ) -> torch.Tensor:
    """Launch pandora_conv3x3_fused (`fused`) or pandora_conv3x3 and count
    it on its wrapper."""
    wrapper = conv3x3_fused if fused else conv3x3_nhwc
    name = wrapper.__name__
    x = x.contiguous()  # a no-op on the UNet's channel-last activations
    bsz, h, wd, c = x.shape
    co = packed.shape[0]
    bias = (torch.zeros(co, dtype=torch.float32, device=x.device)
            if b is None else b.float().contiguous())
    if bias.data_ptr() % 16:  # the kernel reads it in 16-byte pieces
        bias = bias.clone()
    scale = None if scale is None else scale.float().contiguous()
    shift = None if shift is None else shift.float().contiguous()
    residual = None if residual is None else residual.to(x.dtype).contiguous()
    present = [t for t in (scale, shift, residual) if t is not None]
    kernels.check_cuda_tensors(name, x, packed, bias, *present)
    check_shapes(name, x, packed, scale, shift, residual)
    out = torch.empty((bsz, h, wd, co), dtype=x.dtype, device=x.device)
    lib = kernels.library()
    with torch.cuda.device(x.device):
        if fused:
            err = lib.pandora_conv3x3_fused(
                x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                *[None if t is None else t.data_ptr()
                  for t in (scale, shift, residual)],
                out.data_ptr(), bsz, h, wd, c, co,
                kernels.DTYPE_CODES[x.dtype], kernels.stream_handle(x))
        else:
            err = lib.pandora_conv3x3(
                x.data_ptr(), packed.data_ptr(), bias.data_ptr(),
                out.data_ptr(), bsz, h, wd, c, co,
                kernels.DTYPE_CODES[x.dtype], kernels.stream_handle(x))
    kernels.check_cuda(err, "pandora_" + ("conv3x3_fused" if fused
                                         else "conv3x3"))
    wrapper.launches += 1
    return out


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor,
                 b: Optional[torch.Tensor] = None, *,
                 packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, H, W, C) * w (3, 3, C, Co) [+ b (Co,)] -> (B, H, W, Co), stride
    1, same padding, fp32 accumulation, out in x.dtype. A CPU tensor gets
    the plain version; a CUDA tensor the kernel (pandora_conv3x3) or an
    exception."""
    if x.device.type == "cpu":
        return conv3x3_nhwc_plain(x, w, b)
    packed = pack_weight(w, x.dtype) if packed is None else packed
    return _conv_cuda(x, packed, b, None, None, None, fused=False)


conv3x3_nhwc.launches = 0


def conv3x3_fused(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None,
                  shift: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None, *,
                  packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """conv3x3(silu(x * scale + shift)) + b + residual, stride 1, same
    padding in the activated domain, fp32 accumulation, out in x.dtype.
    scale/shift (B, C) fp32, both or neither (None: no prologue); residual
    (B, H, W, Co) or None. A CPU tensor gets the plain version; a CUDA
    tensor the kernel (pandora_conv3x3_fused) or an exception."""
    if x.device.type == "cpu":
        return conv3x3_fused_plain(x, w, b, scale, shift, residual)
    packed = pack_weight(w, x.dtype) if packed is None else packed
    return _conv_cuda(x, packed, b, scale, shift, residual, fused=True)


conv3x3_fused.launches = 0
