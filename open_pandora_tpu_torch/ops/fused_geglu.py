"""Fused GEGLU feed-forward with its LayerNorm and residual,
x + FF(LN(x)): the CUDA kernels (csrc/fused_geglu.cu), their launch plan,
the plain version, and the op that picks between them by device.

Counterpart of open_pandora_tpu/ops/fused_geglu.py (Pallas `_kernel`,
through `_forward` <- `fused_geglu_ff`). As there, the op is wired into no
model: BasicTransformerBlock keeps LN3 -> GEGLU -> Linear. Weights are in
the JAX layout: w1 (c, 2 inner) with the value columns first, w2
(inner, c). The gradient is the JAX custom VJP's: the backward
differentiates the plain version (`geglu_ff_plain`, the counterpart of
`geglu_ff_xla`); there is no backward kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from open_pandora_tpu_torch.ops import kernels

# the JAX package's VMEM tile model, copied as its gate's rule only: it
# never tiles the card's kernel
_VMEM_BUDGET = 8 * 2 ** 20
# the card's kernels: GEMM tiles of 128 rows, a block's shared memory, the
# LN pass's widest row (a warp holds it in its registers)
TILE_ROWS = 128
SMEM_LIMIT = 232448
MAX_C = 4096
# bf16: up-projection tiles of 128 value and the same 128 gate columns
BF16_VALUE_COLS = 128
# fp32 (split TF32): pieces of 32 k, four A slots of 128 rows, three raw
# and two split (hi, lo) weight slots of the tile's columns
# (`TF32Plan`)
TF32_PIECE = 32
TF32_A_SLOTS = 4
TF32_W_SLOTS = 3 + 2 * 2


def _vmem_bytes(r: int, c: int, ck: int) -> int:
    return (2 * 3 * c * ck * 2 + 2 * r * ck * 4 + r * c * 4 + r * c * 2
            + 2 * 2 * r * c * 2)


def _pick_tiles(c: int, inner: int):
    for r in (256, 128, 64):
        for ck in (640, 512, 256, 128):
            if inner % ck == 0 and _vmem_bytes(r, c, ck) <= _VMEM_BUDGET:
                return r, ck
    return None


def geglu_ff_eligible(c: int, mult: int = 4) -> bool:
    """The JAX gate (`geglu_ff_eligible`: a tile plan within its VMEM
    model), and what the card's kernels take: c a multiple of 32. The
    kernels' own widest c (4096, the LN pass's registers) lies beyond the
    JAX gate's widest (3392)."""
    return _pick_tiles(c, c * mult) is not None and c % 32 == 0


class LaunchPlan(NamedTuple):
    """How the kernels cover one call: the LN pass into the workspace xn
    (R, c), the up-projection with the GEGLU epilogue into the workspace h
    (R, inner), the down-projection with b2 and the residual; `workspace`
    holds their shapes, in x's dtype. Both GEMMs are persistent on `ctas` =
    (up, down) blocks; an up-projection tile pairs bv value columns with
    the same bv gate columns, a down-projection tile is bn output columns
    wide, both 128 rows. bf16 (route "wgmma"): bv 128, bn 256 where c % 256
    == 0, else 128; each GEMM's ring fills a block's shared memory (`smem`
    empty). fp32 (route "tf32", split TF32): bv 80 where inner % 80 == 0,
    else 64; bn 160 where c % 160 == 0, else 128; `smem` = (up, down) bytes
    of a block's shared memory at the kernel's fixed ring depths."""
    route: str
    bv: int
    bn: int
    ctas: tuple
    workspace: tuple
    smem: tuple


def _smem_tf32(n: int) -> int:
    """`TF32Plan<n>::kSmem`."""
    return (1024 + TF32_A_SLOTS * TILE_ROWS * TF32_PIECE * 4
            + TF32_W_SLOTS * n * TF32_PIECE * 4 + 256)


@functools.lru_cache(maxsize=None)
def launch_plan(r: int, c: int, inner: int, dtype: torch.dtype,
                sms: int) -> Optional[LaunchPlan]:
    """The plan for x (r, c) at the given inner width on a card of `sms`
    multiprocessors, or None where the kernels cannot run it. The GEMMs are
    persistent: at most one block a multiprocessor, each walking tiles."""
    if c % 32 or c > MAX_C or r <= 0:
        return None
    if dtype == torch.float32:
        if inner % TF32_PIECE:
            return None
        bv = 80 if inner % 80 == 0 else 64
        bn = 160 if c % 160 == 0 else 128
        smem = (_smem_tf32(2 * bv), _smem_tf32(bn))
        route = "tf32"
    else:
        if inner % BF16_VALUE_COLS:
            return None
        bv = BF16_VALUE_COLS
        bn = 256 if c % 256 == 0 else 128
        smem = ()
        route = "wgmma"
    blocks = -(-r // TILE_ROWS)
    tiles = (blocks * -(-inner // bv), blocks * -(-c // bn))
    return LaunchPlan(route, bv, bn, tuple(min(t, sms) for t in tiles),
                      ((r, c), (r, inner)), smem)


def _wide(dt: torch.dtype) -> torch.dtype:
    """The dtype the plain version computes in: the wider of dt and fp32
    (float64 stays float64, the reference the card's fp32 kernel is held
    to)."""
    return torch.promote_types(dt, torch.float32)


def _layer_norm(x2, g, b, eps):
    """LN with statistics in the wide dtype and a centred variance, cast to
    x's dtype."""
    wt = _wide(x2.dtype)
    xf = x2.to(wt)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.to(wt)
            + b.to(wt)).to(x2.dtype)


def geglu_gated_plain(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The first half of `geglu_ff_xla`, the tensor h that the card's
    kernels pass from one GEMM to the other through device memory: LN, the
    up-projection and its bias in x's dtype, the exact-erf gate in the wide
    dtype (fp32, or float64 for float64 x), v * gelu(g) cast to x's
    dtype."""
    dt = x2.dtype
    wt = _wide(dt)
    hh = _layer_norm(x2, g, b, eps) @ w1 + b1.to(dt)
    val, gate = hh.chunk(2, dim=-1)
    return (val.to(wt) * F.gelu(gate.to(wt))).to(dt)


def geglu_ff_plain(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """`geglu_ff_xla`: the gated rows h (`geglu_gated_plain`), then the
    down-projection and its bias in x's dtype and the residual. Also the
    function the op's backward differentiates."""
    h = geglu_gated_plain(x2, g, b, w1, b1, eps)
    return x2 + (h @ w2 + b2.to(x2.dtype))


def check_shapes(x2, g, b, w1, b1, w2, b2) -> None:
    """What the kernels take, device aside: x (R, c) fp32 or bf16 and every
    weight in its dtype, contiguous and 16-byte aligned; w1 (c, 2 inner),
    w2 (inner, c); c a multiple of 32, at most 4096; inner a multiple of
    128 in bf16, of 32 in fp32."""
    name = "fused_geglu_ff"
    if x2.dtype not in kernels.DTYPE_CODES or x2.ndim != 2:
        raise ValueError(f"{name}: needs fp32 or bf16 rows, got {x2.dtype} "
                         f"{tuple(x2.shape)}")
    r, c = x2.shape
    inner = w2.shape[0]
    shapes = ((g, (c,)), (b, (c,)), (w1, (c, 2 * inner)), (b1, (2 * inner,)),
              (w2, (inner, c)), (b2, (c,)))
    if (launch_plan(r, c, inner, x2.dtype, 1) is None
            or any(t.shape != s for t, s in shapes)):
        raise ValueError(f"{name}: bad shapes x {tuple(x2.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} "
                         "(c % 32 == 0, c <= 4096; inner % 128 == 0 in "
                         "bf16, % 32 in fp32)")
    for t in (x2, g, b, w1, b1, w2, b2):
        if t.dtype != x2.dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be contiguous, "
                             "16-byte aligned and in x's dtype")


def _geglu_cuda(x2, g, b, w1, b1, w2, b2, eps):
    kernels.check_cuda_tensors("fused_geglu_ff", x2, g, b, w1, b1, w2, b2)
    check_shapes(x2, g, b, w1, b1, w2, b2)
    r, c = x2.shape
    inner = w2.shape[0]
    plan = launch_plan(r, c, inner, x2.dtype,
                       kernels.multiprocessors(x2.device))
    out = torch.empty_like(x2)
    # the workspaces come from PyTorch's caching allocator, per call
    xn, h = (torch.empty(s, dtype=x2.dtype, device=x2.device)
             for s in plan.workspace)
    with torch.cuda.device(x2.device):
        err = kernels.library().pandora_fused_geglu(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            xn.data_ptr(), h.data_ptr(), r, c, inner, plan.bv, plan.bn,
            *plan.ctas, float(eps), kernels.DTYPE_CODES[x2.dtype],
            kernels.stream_handle(x2))
    kernels.check_cuda(err, "pandora_fused_geglu")
    fused_geglu_ff.launches += 1
    return out


class _FusedFF(torch.autograd.Function):
    """Forward: the kernel on a CUDA tensor, the plain version on a CPU
    one. Backward: autograd through the plain version on the saved inputs
    (the JAX package's `_fused_ff_bwd`)."""

    @staticmethod
    def forward(ctx, x2, g, b, w1, b1, w2, b2, eps):
        ctx.eps = eps
        ctx.save_for_backward(x2, g, b, w1, b1, w2, b2)
        if x2.device.type == "cpu":
            return geglu_ff_plain(x2, g, b, w1, b1, w2, b2, eps)
        return _geglu_cuda(x2, g, b, w1, b1, w2, b2, eps)

    @staticmethod
    def backward(ctx, ct):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = geglu_ff_plain(*inputs, ctx.eps)
        grads = torch.autograd.grad(out, inputs, ct)
        return (*grads, None)


def fused_geglu_ff(x: torch.Tensor, ln_scale: torch.Tensor,
                   ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor, *,
                   eps: float = 1e-5) -> torch.Tensor:
    """x + FF(LN(x)) over the last axis; leading axes are flattened into
    rows. w1: (c, 2 inner), value columns first; w2: (inner, c)."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    out = _FusedFF.apply(x2, ln_scale, ln_bias, w1, b1, w2, b2, eps)
    return out.reshape(x.shape)


fused_geglu_ff.launches = 0
