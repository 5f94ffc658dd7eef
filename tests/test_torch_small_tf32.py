"""PyTorch port, rows 2 and 10 at fp32: why the fp32 small-attention
kernels (csrc/small_attn_fwd.cu `small_attn_fwd_f32_kernel`,
csrc/small_attn_bwd.cu `small_attn_bwd_f32_kernel`) run every product as
three TF32 products of split operands. Their arithmetic, emulated in plain
PyTorch on the CPU, keeps o, dq, dk and dv within chip_smoke's fp32 rule
(max|x - ref64| <= 8 max|ref32 - ref64|, ref64 the plain versions in
float64 on the same inputs); one TF32 pass breaks it. The card holds the
kernels themselves to the same rule (chip_smoke.py phase 3)."""

import numpy as np
import pytest
import torch

import chip_smoke
from open_pandora_tpu_torch.ops import small_attention as tsa

CHAIN = 64  # k values one tensor-core chain sums at most


def _tf32(x):
    """cvt.rna.tf32.f32: x's fp32 mantissa rounded to 10 bits, to nearest
    with ties away from zero (the sign bit stays apart from the magnitude
    the carry runs through)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _chained(eq, a, b):
    """einsum(eq, a, b) in fp32 as partial sums over at most CHAIN values
    of the contracted index, added afterwards (the kernels' fresh
    partials)."""
    ins, _ = eq.split("->")
    sa, sb = ins.split(",")
    (c,) = set(sa) & set(sb) - set(eq.split("->")[1])
    ia, ib = sa.index(c), sb.index(c)
    n = a.shape[ia]
    out = 0
    for i in range(0, n, CHAIN):
        out = out + torch.einsum(eq, a.narrow(ia, i, min(CHAIN, n - i)),
                                 b.narrow(ib, i, min(CHAIN, n - i)))
    return out


def _tf32_product(eq, a, b, n_parts):
    """einsum(eq, a, b) as the fp32 small-attention kernels run it: each
    operand x = hi + lo (hi = tf32(x), lo = tf32(x - hi)); the big term
    hi_a hi_b and the small terms lo_a hi_b + hi_a lo_b in chains of at
    most CHAIN values, added in fp32; n_parts = 1: hi_a hi_b alone, one
    TF32 pass."""
    ah, bh = _tf32(a), _tf32(b)
    if n_parts == 1:
        return _chained(eq, ah, bh)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return _chained(eq, ah, bh) + (_chained(eq, al, bh)
                                   + _chained(eq, ah, bl))


def _emulation(q, k, v, do, scale, n_parts):
    """The fp32 kernels' arithmetic: S, dP and the four products with p and
    ds by `_tf32_product` (p and ds fp32, split like any operand), the
    softmax, rowsum(dp p) and ds in fp32. Returns o, dq, dk, dv."""
    s = _tf32_product("bnhd,bmhd->bhnm", q, k, n_parts) * scale
    p = torch.softmax(s, dim=-1)
    o = _tf32_product("bhnm,bmhd->bnhd", p, v, n_parts)
    dp = _tf32_product("bnhd,bmhd->bhnm", do, v, n_parts)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * scale
    return (o, _tf32_product("bhnm,bmhd->bnhd", ds, k, n_parts),
            _tf32_product("bhnm,bnhd->bmhd", ds, q, n_parts),
            _tf32_product("bhnm,bnhd->bmhd", p, do, n_parts))


# (n, m, d): t = 16 at the head widths of the kernel's three instances
# (32; 64; 72 with its k8 tail and 128, two chains over D), and a ragged
# N < M
@pytest.mark.parametrize("n,m,d", [
    (16, 16, 32),
    (16, 16, 64),
    (16, 16, 72),
    (16, 16, 128),
    (7, 16, 48),
])
def test_split_tf32_small_attention_holds_the_ref64_rule(n, m, d):
    """Split TF32 keeps o, dq, dk and dv within the ref64 rule of the
    float64 plain versions; one TF32 pass breaks it for every one."""
    b, h = 24, 4
    rng = np.random.default_rng(17)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   for s in ((b, n, h, d), (b, m, h, d), (b, m, h, d),
                             (b, n, h, d)))
    scale = d ** -0.5
    ref32 = (tsa.small_attention_plain(q, k, v),
             *tsa.small_attention_bwd_plain(q, k, v, do))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    ref64 = (tsa.small_attention_plain(q64, k64, v64),
             *tsa.small_attention_bwd_plain(q64, k64, v64, do64))
    assert all(r.dtype == torch.float64 for r in ref64)
    split = _emulation(q, k, v, do, scale, 2)
    single = _emulation(q, k, v, do, scale, 1)
    for name, r32, r64, x3, x1 in zip(("o", "dq", "dk", "dv"), ref32, ref64,
                                      split, single):
        err, bound = chip_smoke._ref64_bound(x3, r32, r64)
        assert err <= bound, (name, err, bound)
        err1, _ = chip_smoke._ref64_bound(x1, r32, r64)
        assert err1 > bound, (name, err1, bound)
