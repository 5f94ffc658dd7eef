"""PyTorch port, rows 8 and 13: the launch plans of the dual
cross-attention kernel and the GEGLU kernels cover every phase-3 shape of
chip_smoke.py within the card's limits, the wrappers route by shape and
alignment and hand the C launchers the plans they chose, the eager
yardsticks compute the rows' functions, and the plain GEGLU's gated rows,
the h that the card's two GEMMs pass through device memory, are the bf16
values of the JAX twin's. No card needed: a stand-in library records the C
calls' arguments."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import open_pandora_tpu.ops.fused_geglu as fg
from open_pandora_tpu_torch.ops import dual_cross_attention as tdca
from open_pandora_tpu_torch.ops import fused_geglu as tfg
from open_pandora_tpu_torch.ops import kernels

BF16 = torch.bfloat16
SMS = 132   # an H100 SXM's multiprocessors


def _ceil(a, b):
    return -(-a // b)


# -- row 8 -------------------------------------------------------------------

@pytest.mark.parametrize("case", chip_smoke.DUAL_CROSS_CASES)
def test_dual_plan_covers_every_q_tile(case):
    """Every 64-row q tile of every (b, h) falls in exactly one block, the
    block's shared memory fits, and the warpgroups' shares are even: none
    walks more than one tile over the least any split could give it."""
    b, n, h, d, (mt, mi), _ = case
    plan = tdca.launch_plan(b, n, h, d, mt, mi, SMS)
    ntiles = _ceil(n, 64)
    blocks = plan.grid[0]
    assert plan.grid[1:] == (h, b)
    assert (blocks - 1) * plan.tiles_per_block < ntiles \
        <= blocks * plan.tiles_per_block
    assert plan.smem <= tdca.SMEM_LIMIT
    assert plan.dmax == (64 if d <= 64 else 128)
    assert _ceil(plan.tiles_per_block, 2) <= _ceil(b * h * ntiles, 2 * SMS) + 1


@pytest.mark.parametrize("mt,mi,d,resident", [
    (77, 16, 80, True),      # the UNet's attn2: two key tiles on chip
    (77, 16, 48, True),
    (100, 130, 48, True),    # four tiles of 64 columns
    (160, 160, 128, True),   # four tiles of 128 columns, the most that fit
    (240, 160, 128, False),
    (512, 512, 128, False),  # the gate's longest streams
    (512, 512, 64, False),
])
def test_dual_plan_holds_short_streams_on_chip(mt, mi, d, resident):
    """Key tiles of up to 80 keys; a K and a V tile per slot, beside four
    64-row q stages."""
    plan = tdca.launch_plan(32, 2560, 4, d, mt, mi, SMS)
    assert plan.resident is resident
    slots = _ceil(mt, 80) + _ceil(mi, 80) if resident else 4
    atoms = plan.dmax // 64
    assert plan.smem == 1024 + (4 * 64 + 2 * slots * 80) * 128 * atoms


def test_dual_phase3_reaches_every_route():
    """Phase 3 holds the kernel on both key regimes, both head-width
    instances and a head width with a k16 tail."""
    plans = [(tdca.launch_plan(b, n, h, d, *ms, SMS), d)
             for b, n, h, d, ms, _ in chip_smoke.DUAL_CROSS_CASES]
    assert {p.resident for p, _ in plans} == {True, False}
    assert {p.dmax for p, _ in plans} == {64, 128}
    assert any(d % 16 == 8 for _, d in plans)
    # the UNet's attn2 at head width 80 (phase 5b) stays on chip
    assert tdca.launch_plan(32, 2560, 4, 80, 77, 16, SMS).resident


class _Library:
    """Stands in for the kernel library: records each C call's name and
    arguments and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def library(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "check_cuda_tensors", lambda name, *ts: None)
    monkeypatch.setattr(kernels, "stream_handle", lambda x: None)
    monkeypatch.setattr(kernels, "multiprocessors", lambda dev: SMS)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


def _packed_views(b, n, mt, mi, h, d):
    """q and the two streams as views of packed (B, rows, H*D) rows."""
    def view(rows):
        return torch.randn(b, rows, h * d).to(BF16).view(b, rows, h, d)
    return [view(n), view(mt), view(mt), view(mi), view(mi)]


@pytest.mark.parametrize("b,n,h,d,mt,mi", [(2, 600, 4, 80, 77, 16),
                                           (1, 520, 2, 128, 512, 512)])
def test_dual_wrapper_passes_its_plan(library, b, n, h, d, mt, mi):
    """The wrapper hands the C launcher launch_plan's q tiles per block and
    residency, in the places its signature has for them."""
    ts = _packed_views(b, n, mt, mi, h, d)
    tdca._dual_cuda(*ts, 1.0)
    (name, args), = library.calls
    assert len(args) == len(kernels._SIGNATURES[name])
    plan = tdca.launch_plan(b, n, h, d, mt, mi, SMS)
    # q .. o, then B, N, Mt, Mi, H, D and the plan
    assert args[7:15] == (b, n, mt, mi, h, d, plan.tiles_per_block,
                          int(plan.resident))


def test_dual_wrapper_refuses_rows_off_16_bytes(library):
    """Rows 4-byte but not 16-byte aligned (two elements into rows of 130):
    the gate, which reads shapes only, admits them; the wrapper refuses
    them before any launch (the kernel copies 16-byte pieces)."""
    x = torch.zeros(2, 600, 130, dtype=BF16)[:, :, 2:]
    streams = [x[:, :m].view(2, m, 2, 64) for m in (77, 77, 16, 16)]
    assert tdca.dual_cross_attention_eligible(600, 77, 16, 64)
    with pytest.raises(ValueError, match="16-byte"):
        tdca._dual_cuda(x.view(2, 600, 2, 64), *streams, 1.0)
    assert library.calls == []


@pytest.mark.parametrize("gate", [1.0, 0.6])
def test_eager_yardstick_computes_row_8(gate):
    """chip_smoke's `eager_ms` chain (SDPA on each stream, the gated sum)
    is the kernel's function: in fp32 it matches the plain version."""
    torch.manual_seed(0)
    ts = [t.float() for t in _packed_views(2, 130, 77, 16, 3, 40)]
    want = tdca.dual_cross_attention_plain(*ts, gate)
    got = chip_smoke.dual_cross_eager(*ts, gate)
    assert got.shape == want.shape
    # fp32 in both, summation order only (1e-4, as row 4's yardstick test)
    assert (got - want).abs().max().item() <= 1e-4


# -- row 13 ------------------------------------------------------------------

@pytest.mark.parametrize("r,c,dtype", chip_smoke.GEGLU_CASES)
def test_geglu_plan_fits_the_card(r, c, dtype):
    """Both dtypes: the up-projection's tiles (128 rows by bv value columns
    and the same bv gate columns) and the down-projection's (128 rows by bn
    output columns) cover the rows and columns, no persistent grid exceeds
    the card, the workspaces are xn (r, c) and h (r, inner), and an fp32
    block's shared memory fits. bf16: bv 128, bn 256 where c % 256 == 0,
    else 128; fp32 (split TF32): bv 80 where inner % 80 == 0, else 64; bn
    160 where c % 160 == 0, else 128."""
    inner = 4 * c
    plan = tfg.launch_plan(r, c, inner, dtype, SMS)
    if dtype == torch.float32:
        assert plan.route == "tf32"
        assert plan.bv == (80 if inner % 80 == 0 else 64)
        assert plan.bn == (160 if c % 160 == 0 else 128)
        assert len(plan.smem) == 2
    else:   # the bf16 rings fill a block's shared memory in C
        assert plan.route == "wgmma"
        assert plan.bv == 128
        assert plan.bn == (256 if c % 256 == 0 else 128)
        assert plan.smem == ()
    blocks = _ceil(r, 128)
    tiles = (blocks * _ceil(inner, plan.bv), blocks * _ceil(c, plan.bn))
    assert plan.ctas == tuple(min(t, SMS) for t in tiles)
    assert plan.workspace == ((r, c), (r, inner))
    assert all(0 < m <= tfg.SMEM_LIMIT for m in plan.smem)
    # h: the gated rows, 2 r inner bytes in bf16 (755 MB at 576x1024 level
    # 0), twice that in fp32
    if (r, c) == (294912, 320):
        assert 2 * r * inner == 754974720


@pytest.mark.parametrize("c,bv,bn,smem", [(640, 80, 160, (210176, 210176)),
                                          (1920, 80, 160, (210176, 210176)),
                                          (3392, 64, 128, (181504, 181504))])
def test_geglu_fp32_plan_fits_every_width(c, bv, bn, smem):
    """The fp32 plan at the UNet's width 640, the widest the phase-3 cases
    take (1920) and the JAX gate's widest (3392, where inner = 13568 is no
    multiple of 80 and c no multiple of 160): the tile widths, shared memory
    at the kernel's fixed ring depths (`TF32Plan`: 1024 + four 16 KB A
    slots + seven weight slots of 128 bytes a column + 256), and tiles that
    cover inner and c."""
    plan = tfg.launch_plan(64, c, 4 * c, torch.float32, SMS)
    assert (plan.bv, plan.bn, plan.smem) == (bv, bn, smem)
    assert smem == tuple(1024 + 4 * 16384 + 7 * n * 128 + 256
                         for n in (2 * bv, bn))
    assert plan.ctas == (min(_ceil(4 * c, bv), SMS), _ceil(c, bn))


def test_geglu_plan_refuses_what_the_kernels_cannot_run():
    assert tfg.launch_plan(64, 48, 192, BF16, SMS) is None       # c % 32
    assert tfg.launch_plan(64, 64, 192, BF16, SMS) is None       # inner % 128
    assert tfg.launch_plan(64, 64, 192, torch.float32, SMS)      # fp32 takes it
    assert tfg.launch_plan(64, 4128, 4 * 4128, BF16, SMS) is None  # LN rows
    # every width the JAX gate admits at inner = 4c has a plan
    for c in range(32, 3456, 32):
        if fg.geglu_ff_eligible(c):
            for dt in (BF16, torch.float32):
                assert tfg.launch_plan(8, c, 4 * c, dt, SMS) is not None


def _geglu_args(r, c, dtype=BF16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    inner = 4 * c

    def n(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=gen) * scale + shift).to(dtype)
    return (n(r, c, scale=3.0), n(c, scale=0.1, shift=1.0), n(c, scale=0.05),
            n(c, 2 * inner, scale=c ** -0.5), n(2 * inner, scale=0.02),
            n(inner, c, scale=inner ** -0.5), n(c, scale=0.02))


@pytest.mark.parametrize("r,c", [(300, 64), (77, 256)])
def test_geglu_wrapper_passes_its_plan(library, r, c):
    """Both dtypes: the wrapper allocates the two workspaces in x's dtype
    and hands them to C with the plan's tile widths and grids."""
    args = _geglu_args(r, c)
    for dt in (BF16, torch.float32):
        library.calls.clear()
        tfg._geglu_cuda(*[a.to(dt) for a in args], 1e-5)
        (name, cargs), = library.calls
        assert len(cargs) == len(kernels._SIGNATURES[name])
        plan = tfg.launch_plan(r, c, 4 * c, dt, SMS)
        # x .. out, xn, h, then R, c, inner, bv, bn, the two grids
        assert cargs[8] is not None and cargs[9] is not None
        assert cargs[8] != cargs[9]
        assert cargs[10:17] == (r, c, 4 * c, plan.bv, plan.bn, *plan.ctas)
        assert cargs[18] == kernels.DTYPE_CODES[dt]
    assert tfg.launch_plan(r, c, 4 * c, torch.float32, SMS).route == "tf32"


class _Capture:
    """Stands in for W2 in the JAX twin: `gated @ w2` hands it the gated
    rows, and it returns zeros of the output's shape."""

    def __init__(self, c):
        self.c = c
        self.gated = None

    def __rmatmul__(self, gated):
        self.gated = gated
        return jnp.zeros(gated.shape[:-1] + (self.c,), gated.dtype)


def _jax_gated(args, dtype, eps):
    ja = [jnp.asarray(a.float().numpy()).astype(dtype) for a in args]
    cap = _Capture(ja[0].shape[-1])
    fg.geglu_ff_xla(*ja, cap, jnp.zeros(cap.c, dtype), eps)
    return np.asarray(cap.gated.astype(jnp.bfloat16).astype(jnp.float32))


def _exact_inputs(r, c, seed):
    """Inputs on which both packages compute every step before the gate
    exactly and the bf16 cast after it alike: rows of +-2 with mean 0 (LN's
    statistics exact; with eps = 0 its scale is 1/2), LN gain 1 and shift
    0, value weights and biases in quarters (exact sums of a few bits), gate
    weights 0 and gate biases 0 or 8. gelu(0) is 0 in both; gelu(8) is 8
    within one fp32 rounding in both (JAX's erf stops short of 1), and v 8
    has few bits, so both casts give it exactly."""
    rng = np.random.default_rng(seed)
    inner = 4 * c
    x = np.where(np.arange(c) % 2 == 0, 2.0, -2.0)[None].repeat(r, 0)
    x = np.take_along_axis(x, rng.permuted(
        np.tile(np.arange(c), (r, 1)), axis=1), axis=1)
    w1 = np.zeros((c, 2 * inner))
    w1[:, :inner] = rng.integers(-2, 3, (c, inner)) / 4
    b1 = np.concatenate([rng.integers(-8, 9, inner) / 4,
                         rng.choice([0.0, 8.0], inner)])
    return [torch.tensor(a, dtype=torch.float32) for a in
            (x, np.ones(c), np.zeros(c), w1, b1)]


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (BF16, jnp.bfloat16)])
def test_geglu_h_round_trip_bit_equal_to_jax(dtype, jdtype):
    """The plain version's h, in bf16 as the card's GEMMs pass it, is
    bit-equal to the bf16 cast of the gated rows inside the JAX twin
    (`geglu_ff_xla`) at a narrow width (c = 32), on inputs where both
    packages compute every step exactly; elsewhere the two packages' erf
    differ in the last bits (a CPU library difference, not the round
    trip), so random inputs agree within one bf16 rounding step, or 1e-6
    in the gate's far negative tail, where 1 + erf(g) cancels."""
    args = [a.to(dtype) for a in _exact_inputs(96, 32, seed=0)]
    h = tfg.geglu_gated_plain(*args, eps=0.0).to(BF16).float().numpy()
    want = _jax_gated(args, jdtype, 0.0)
    assert h.shape == (96, 128)
    assert np.array_equal(h, want)
    assert np.count_nonzero(h) > h.size // 4     # the gate is not all zero
    rnd = [a.to(dtype) for a in _geglu_args(96, 32, seed=5)[:5]]
    h = tfg.geglu_gated_plain(*rnd).to(BF16).float().numpy()
    want = _jax_gated(rnd, jdtype, 1e-5)
    assert np.all(np.abs(h - want) <= 2 ** -7 * np.abs(want) + 1e-6)


def test_geglu_plain_is_the_round_trip():
    """geglu_ff_plain is x + h W2 + b2 with h from geglu_gated_plain."""
    args = _geglu_args(50, 64)
    h = tfg.geglu_gated_plain(*args[:5])
    want = args[0] + (h @ args[5] + args[6])
    assert torch.equal(tfg.geglu_ff_plain(*args), want)


def test_eager_yardstick_computes_row_13():
    """chip_smoke's `eager_ms` chain (F.layer_norm, F.linear, v * gelu(g),
    F.linear, the residual) is the op's function: in fp32 it matches the
    plain version."""
    args = [a.float() for a in _geglu_args(40, 64)]
    want = tfg.geglu_ff_plain(*args)
    got = chip_smoke.geglu_eager(*args)
    assert (got - want).abs().max().item() <= 1e-4
