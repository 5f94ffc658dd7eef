"""PyTorch port, rows 11 and 12 at fp32: why the fp32 conv kernel
(csrc/conv3x3.cu `conv3x3_tf32_kernel`) runs every product as three TF32
products of split operands. Its arithmetic, emulated in plain PyTorch on the
CPU, keeps the output within chip_smoke's fp32 rule (max|x - ref64| <= 8
max|ref32 - ref64|, ref64 the plain version in float64 on the same inputs);
one TF32 pass breaks it. The card holds the kernel itself to the same rule
(chip_smoke.py phase 3).

The emulation follows the kernel: K ordered (tap, channel); the sum taken
in pieces of at most 32 k values, one tap of one 32-channel chunk (below 32
channels, a 32-wide k slice of the packed weight, spanning 32 / C taps);
in each piece the small terms lo hi + hi lo, then the big term hi hi; the
pieces' sums added in fp32, then the bias and the residual."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from open_pandora_tpu_torch.ops import conv2d as tc2

CHUNK = 32  # channels a halo chunk holds: k values one piece sums at most


def _tf32(x):
    """cvt.rna.tf32.f32: x's fp32 mantissa rounded to 10 bits, to nearest
    with ties away from zero (the sign bit stays apart from the magnitude
    the carry runs through)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _im2col(x):
    """(B, H, W, C) -> (B H W, 9 C), zero padded, k = (3 ky + kx) C + c:
    the packed weight's k order."""
    bsz, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    taps = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3)
            for dx in range(3)]
    return torch.cat(taps, -1).reshape(bsz * h * w, 9 * c)


def _pieces(c):
    """The kernel's pieces in its order, each a tensor of k indices."""
    k = 9 * c
    if c < CHUNK:
        return [torch.arange(j, min(k, j + CHUNK)) for j in range(0, k, CHUNK)]
    return [torch.arange(tap * c + c0, tap * c + min(c, c0 + CHUNK))
            for c0 in range(0, c, CHUNK) for tap in range(9)]


def _emulation(x, w, b, scale, shift, residual, n_parts):
    """conv3x3(silu(x * scale + shift)) + b + residual as the fp32 kernel
    runs it: each operand v = hi + lo (hi = tf32(v), lo = tf32(v - hi));
    per piece (lo_a hi_b + hi_a lo_b) + hi_a hi_b, the pieces summed in
    fp32; n_parts = 1: hi_a hi_b alone, one TF32 pass."""
    bsz, h, wd, c = x.shape
    if scale is not None:
        x = F.silu(x * scale[:, None, None, :] + shift[:, None, None, :])
    a = _im2col(x)
    wk = tc2.pack_weight(w, torch.float32).t()          # (9 C, Co)
    ah, wh = _tf32(a), _tf32(wk)
    al, wl = _tf32(a - ah), _tf32(wk - wh)
    total = torch.zeros(a.shape[0], wk.shape[1])
    for k in _pieces(c):
        big = ah[:, k] @ wh[k]
        if n_parts == 1:
            total = total + big
        else:
            total = total + ((al[:, k] @ wh[k] + ah[:, k] @ wl[k]) + big)
    y = total.reshape(bsz, h, wd, -1) + b
    return y if residual is None else y + residual


# (C, Co, H, W): the input conv's C = 8 (one piece spans four taps), C = 64
# (two chunks), C = 320 at a narrow image (ten chunks, K = 2880); each
# plain and with the prologue and the residual
@pytest.mark.parametrize("variant", ["plain", "pro_res"])
@pytest.mark.parametrize("c,co,h,w", [
    (8, 32, 8, 8),
    (64, 48, 8, 8),
    (320, 64, 4, 6),
])
def test_split_tf32_conv_holds_the_ref64_rule(c, co, h, w, variant):
    """Split TF32 keeps the conv within the ref64 rule of the float64
    plain version; one TF32 pass breaks it."""
    bsz = 2
    rng = np.random.default_rng(18)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32))
    x = rnd(bsz, h, w, c)
    wt = rnd(3, 3, c, co, scale=(9 * c) ** -0.5)
    b = rnd(co, scale=0.1)
    pro = variant == "pro_res"
    scale = rnd(bsz, c, scale=0.1, shift=1.0) if pro else None
    shift = rnd(bsz, c, scale=0.5) if pro else None
    res = rnd(bsz, h, w, co) if pro else None

    def d64(t):
        return None if t is None else t.double()
    ref32 = tc2.conv3x3_fused_plain(x, wt, b, scale, shift, res)
    ref64 = tc2.conv3x3_fused_plain(x.double(), wt.double(), b.double(),
                                    d64(scale), d64(shift), d64(res))
    assert ref32.dtype == torch.float32 and ref64.dtype == torch.float64
    split = _emulation(x, wt, b, scale, shift, res, 2)
    single = _emulation(x, wt, b, scale, shift, res, 1)
    err, bound = chip_smoke._ref64_bound(split, ref32, ref64)
    assert err <= bound, (err, bound)
    err1, _ = chip_smoke._ref64_bound(single, ref32, ref64)
    assert err1 > bound, (err1, bound)


def test_plain_keeps_float64_and_the_other_dtypes():
    """conv3x3_fused_plain computes float64 inputs in float64 (the
    reference above), fp32 in fp32 and bf16 with its casts as before."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 5, 6, 16))
    wt = rng.standard_normal((3, 3, 16, 24)) / 12
    b = rng.standard_normal(24).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal((2, 16))).astype(np.float32)
    shift = (0.5 * rng.standard_normal((2, 16))).astype(np.float32)
    res = rng.standard_normal((2, 5, 6, 24))
    t = torch.from_numpy
    out = tc2.conv3x3_fused_plain(t(x), t(wt), t(b), t(scale), t(shift),
                                  t(res))
    assert out.dtype == torch.float64
    xs = F.silu(t(x) * t(scale).double()[:, None, None, :]
                + t(shift).double()[:, None, None, :])
    want = F.conv2d(xs.permute(0, 3, 1, 2), t(wt).permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1) + t(b).double() + t(res)
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 0.0)):
        got = tc2.conv3x3_fused_plain(t(x).to(dt), t(wt).to(dt), t(b),
                                      t(scale), t(shift), t(res).to(dt))
        assert got.dtype == dt
        if dt == torch.float32:
            torch.testing.assert_close(got.double(), want, rtol=tol,
                                       atol=tol)
        else:   # the casts of the bf16 kernel: prologue and weight in bf16
            xb = F.silu(t(x).to(dt).float() * t(scale)[:, None, None, :]
                        + t(shift)[:, None, None, :]).to(dt).float()
            wb = t(wt).to(dt).float().permute(3, 2, 0, 1)
            yb = (F.conv2d(xb.permute(0, 3, 1, 2), wb, padding=1)
                  .permute(0, 2, 3, 1) + t(b)
                  + t(res).to(dt).float()).to(dt)
            assert torch.equal(got, yb)
