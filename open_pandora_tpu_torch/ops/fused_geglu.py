"""Fused GEGLU feed-forward with its LayerNorm and residual,
x + FF(LN(x)): the CUDA kernel (csrc/fused_geglu.cu), its plain version,
and the op that picks between them by device.

Counterpart of open_pandora_tpu/ops/fused_geglu.py (Pallas `_kernel`,
through `_forward` <- `fused_geglu_ff`). As there, the op is wired into no
model: BasicTransformerBlock keeps LN3 -> GEGLU -> Linear. Weights are in
the JAX layout: w1 (c, 2 inner) with the value columns first, w2
(inner, c). The gradient is the JAX custom VJP's: the backward
differentiates the plain version (`geglu_ff_plain`, the counterpart of
`geglu_ff_xla`); there is no backward kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from open_pandora_tpu_torch.ops import kernels

# the JAX package's VMEM tile model, copied as its gate's rule only: it
# never tiles the card's kernel
_VMEM_BUDGET = 8 * 2 ** 20
# the largest c whose block of 16 rows and its gated rows fit the card's
# shared memory at inner = 4c (csrc/fused_geglu.cu)
_MAX_C = 1280


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
    model), and what the card's kernel takes: c a multiple of 32, at most
    1280."""
    return (_pick_tiles(c, c * mult) is not None and c % 32 == 0
            and c <= _MAX_C)


def geglu_ff_plain(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                   w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                   b2: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """`geglu_ff_xla`: LN with fp32 statistics cast to x's dtype; the
    up-projection and its bias in x's dtype; the exact-erf gate in fp32,
    cast; the down-projection and its bias in x's dtype; the residual. Also
    the function the op's backward differentiates."""
    dt = x2.dtype
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xn = ((xf - mu) * torch.rsqrt(var + eps) * g.float()
          + b.float()).to(dt)
    h = xn @ w1 + b1.to(dt)
    val, gate = h.chunk(2, dim=-1)
    gated = (val.float() * F.gelu(gate.float())).to(dt)
    return x2 + (gated @ w2 + b2.to(dt))


def check_shapes(x2, g, b, w1, b1, w2, b2) -> None:
    """What the kernel takes, device aside: x (R, c) fp32 or bf16 and every
    weight in its dtype, contiguous and 16-byte aligned; w1 (c, 2 inner),
    w2 (inner, c); c a multiple of 32 up to 1280, inner of 64."""
    name = "fused_geglu_ff"
    if x2.dtype not in kernels.DTYPE_CODES or x2.ndim != 2:
        raise ValueError(f"{name}: needs fp32 or bf16 rows, got {x2.dtype} "
                         f"{tuple(x2.shape)}")
    r, c = x2.shape
    inner = w2.shape[0]
    shapes = ((g, (c,)), (b, (c,)), (w1, (c, 2 * inner)), (b1, (2 * inner,)),
              (w2, (inner, c)), (b2, (c,)))
    if (r == 0 or c % 32 or c > _MAX_C or inner % 64
            or any(t.shape != s for t, s in shapes)):
        raise ValueError(f"{name}: bad shapes x {tuple(x2.shape)}, "
                         f"w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)} "
                         "(c % 32 == 0, c <= 1280, inner % 64 == 0)")
    for t in (x2, g, b, w1, b1, w2, b2):
        if t.dtype != x2.dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: every tensor must be contiguous, "
                             "16-byte aligned and in x's dtype")


def _geglu_cuda(x2, g, b, w1, b1, w2, b2, eps):
    kernels.check_cuda_tensors("fused_geglu_ff", x2, g, b, w1, b1, w2, b2)
    check_shapes(x2, g, b, w1, b1, w2, b2)
    r, c = x2.shape
    out = torch.empty_like(x2)
    with torch.cuda.device(x2.device):
        err = kernels.library().pandora_fused_geglu(
            x2.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(), r,
            c, w2.shape[0], float(eps), kernels.DTYPE_CODES[x2.dtype],
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
