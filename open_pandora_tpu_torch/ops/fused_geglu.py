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
# the card's kernels: GEMM tiles of 128 rows (the up-projection's 128 value
# and 128 gate columns), a block's shared memory
TILE_ROWS = 128
TILE_INNER = 128
SMEM_LIMIT = 232448
MAX_C_BF16 = 4096    # the LN pass holds a row in a warp's registers


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
    kernels' own widest c (4096 in bf16, about 5800 in fp32) lies beyond
    the JAX gate's widest (3392)."""
    return _pick_tiles(c, c * mult) is not None and c % 32 == 0


class LaunchPlan(NamedTuple):
    """How the kernels cover one call. bf16 (route "wgmma"): the LN pass,
    then the two persistent GEMMs on ctas = (up, down) blocks, the
    down-projection's tiles bn columns wide, through the workspaces xn
    (R, c) and h (R, inner), whose shapes are `workspace`. fp32 (route
    "scalar"): one kernel of rows_f32 rows a block and no workspace."""
    route: str
    bn: int
    ctas: tuple
    rows_f32: int
    workspace: tuple


@functools.lru_cache(maxsize=None)
def launch_plan(r: int, c: int, inner: int, dtype: torch.dtype,
                sms: int) -> Optional[LaunchPlan]:
    """The plan for x (r, c) at the given inner width on a card of `sms`
    multiprocessors, or None where the kernels cannot run it. The GEMMs are
    persistent: at most one block a multiprocessor, each walking tiles."""
    if c % 32 or r <= 0:
        return None
    if dtype == torch.float32:
        for rows in (8, 4, 2):       # the block's LN and gated rows
            if rows * (c + inner) * 4 <= SMEM_LIMIT:
                return LaunchPlan("scalar", 0, (), rows, ())
        return None
    if inner % TILE_INNER or c > MAX_C_BF16:
        return None
    bn = 256 if c % 256 == 0 else 128     # the down-projection's tiles
    blocks = -(-r // TILE_ROWS)
    tiles = (blocks * (inner // TILE_INNER), blocks * -(-c // bn))
    return LaunchPlan("wgmma", bn, tuple(min(t, sms) for t in tiles), 0,
                      ((r, c), (r, inner)))


def _layer_norm(x2, g, b, eps):
    """LN with fp32 statistics and a centred variance, cast to x's dtype."""
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()
            + b.float()).to(x2.dtype)


def geglu_gated_plain(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                      w1: torch.Tensor, b1: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """The first half of `geglu_ff_xla`, the tensor h that the card's
    kernels pass from one GEMM to the other through device memory: LN, the
    up-projection and its bias in x's dtype, the exact-erf gate in fp32,
    v * gelu(g) cast to x's dtype."""
    dt = x2.dtype
    hh = _layer_norm(x2, g, b, eps) @ w1 + b1.to(dt)
    val, gate = hh.chunk(2, dim=-1)
    return (val.float() * F.gelu(gate.float())).to(dt)


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
    w2 (inner, c); c a multiple of 32; bf16: inner a multiple of 128, c at
    most 4096; fp32: two rows and their gated rows within a block's shared
    memory."""
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
                         "(c % 32 == 0; bf16: inner % 128 == 0)")
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
             for s in plan.workspace) if plan.workspace else (None, None)
    ctas = plan.ctas or (0, 0)
    with torch.cuda.device(x2.device):
        err = kernels.library().pandora_fused_geglu(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            None if xn is None else xn.data_ptr(),
            None if h is None else h.data_ptr(), r, c, inner, plan.bn,
            *ctas, plan.rows_f32, float(eps), kernels.DTYPE_CODES[x2.dtype],
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
