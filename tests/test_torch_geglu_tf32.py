"""PyTorch port, row 13 at fp32: why the fp32 GEGLU kernels
(csrc/fused_geglu.cu `geglu_tf32_kernel`) run both projections as three
TF32 products of split operands. Their arithmetic, emulated in plain PyTorch
on the CPU, keeps the output within chip_smoke's fp32 rule (max|x - ref64|
<= 8 max|ref32 - ref64|, ref64 the plain version in float64 on the same
inputs); one TF32 pass breaks it. The card holds the kernels themselves to
the same rule (chip_smoke.py phase 3).

The emulation follows the kernels: LN in fp32 into xn; the up-projection
xn W1 summed in pieces of 32 k values, in each piece the small terms lo hi
+ hi lo, then the big term hi hi, the pieces' sums added in fp32; h = (v +
b1) gelu(g + b1) in fp32 with the exact erf; the down-projection h W2 in
the same pieces; then (total + b2) + x."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from open_pandora_tpu_torch.ops import fused_geglu as tfg

PIECE = 32  # k values a piece: one 128-byte row of the A tile


def _tf32(x):
    """cvt.rna.tf32.f32: x's fp32 mantissa rounded to 10 bits, to nearest
    with ties away from zero (the sign bit stays apart from the magnitude
    the carry runs through)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(a, w, n_parts):
    """a (R, K) @ w (K, N) as the kernels sum it: each operand v = hi + lo
    (hi = tf32(v), lo = tf32(v - hi)); per 32-k piece (lo_a hi_w + hi_a
    lo_w) + hi_a hi_w, the pieces summed in fp32; n_parts = 1: hi_a hi_w
    alone, one TF32 pass."""
    ah, wh = _tf32(a), _tf32(w)
    al, wl = _tf32(a - ah), _tf32(w - wh)
    total = torch.zeros(a.shape[0], w.shape[1])
    for k0 in range(0, a.shape[1], PIECE):
        k = slice(k0, k0 + PIECE)
        big = ah[:, k] @ wh[k]
        if n_parts == 1:
            total = total + big
        else:
            total = total + ((al[:, k] @ wh[k] + ah[:, k] @ wl[k]) + big)
    return total


def _emulation(x, g, b, w1, b1, w2, b2, n_parts, eps=1e-5):
    """x + W2 (v gelu(g)) + b2 as the three fp32 kernels compute it."""
    xn = tfg._layer_norm(x, g, b, eps)                   # geglu_ln_kernel
    inner = w2.shape[0]
    up = _product(xn, w1, n_parts)                       # value | gate
    v, gate = up[:, :inner] + b1[:inner], up[:, inner:] + b1[inner:]
    h = v * F.gelu(gate)
    return (_product(h, w2, n_parts) + b2) + x


def _inputs(r, c, seed):
    """chip_smoke's row-13 inputs at (r, c), inner = 4c, from a NumPy
    seed."""
    rng = np.random.default_rng(seed)
    inner = 4 * c

    def n(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32))
    return (n(r, c, scale=3.0), n(c, scale=0.1, shift=1.0), n(c, scale=0.05),
            n(c, 2 * inner, scale=c ** -0.5), n(2 * inner, scale=0.02),
            n(inner, c, scale=inner ** -0.5), n(c, scale=0.02))


# (rows, c): one and two 32-k pieces in the up-projection, four and eight
# in the down-projection (k = inner = 4c); ragged row counts
@pytest.mark.parametrize("r,c", [(300, 32), (257, 64)])
def test_split_tf32_geglu_holds_the_ref64_rule(r, c):
    """Split TF32 keeps the feed-forward within the ref64 rule of the
    float64 plain version; one TF32 pass breaks it."""
    args = _inputs(r, c, seed=19)
    ref32 = tfg.geglu_ff_plain(*args)
    ref64 = tfg.geglu_ff_plain(*[a.double() for a in args])
    assert ref32.dtype == torch.float32 and ref64.dtype == torch.float64
    split = _emulation(*args, n_parts=2)
    single = _emulation(*args, n_parts=1)
    err, bound = chip_smoke._ref64_bound(split, ref32, ref64)
    assert err <= bound, (err, bound)
    err1, _ = chip_smoke._ref64_bound(single, ref32, ref64)
    assert err1 > bound, (err1, bound)


def _layer_norm_fp32(x2, g, b, eps):
    """The plain LN as it stood before it kept float64: fp32 statistics,
    cast to x's dtype."""
    xf = x2.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * g.float()
            + b.float()).to(x2.dtype)


def _gated_fp32(x2, g, b, w1, b1, eps=1e-5):
    """geglu_gated_plain as it stood before: the gate in fp32 whatever x's
    dtype."""
    dt = x2.dtype
    hh = _layer_norm_fp32(x2, g, b, eps) @ w1 + b1.to(dt)
    val, gate = hh.chunk(2, dim=-1)
    return (val.float() * F.gelu(gate.float())).to(dt)


def test_plain_keeps_float64_and_the_other_dtypes():
    """geglu_ff_plain computes float64 inputs in float64 (the reference
    above), and fp32 and bf16 bit for bit as before."""
    args = _inputs(50, 32, seed=5)
    d64 = [a.double() for a in args]
    out = tfg.geglu_ff_plain(*d64)
    assert out.dtype == torch.float64
    xn = F.layer_norm(d64[0], (32,), d64[1], d64[2], 1e-5)
    v, gate = (xn @ d64[3] + d64[4]).chunk(2, dim=-1)
    want = d64[0] + (v * F.gelu(gate)) @ d64[5] + d64[6]
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    # the fp32 route sits about 1e-7 of the output's scale away
    assert (tfg.geglu_ff_plain(*args).double() - want).abs().max() > 1e-9
    for dt in (torch.float32, torch.bfloat16):
        ts = [a.to(dt) for a in args]
        h = tfg.geglu_gated_plain(*ts[:5])
        assert h.dtype == dt
        assert torch.equal(h, _gated_fp32(*ts[:5]))
        assert torch.equal(tfg.geglu_ff_plain(*ts),
                           ts[0] + (h @ ts[5] + ts[6]))
