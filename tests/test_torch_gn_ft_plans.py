"""PyTorch port, rows 4 and 5: phase 3 of chip_smoke.py holds every shape
that PandoraConfig()'s UNet hands the fused temporal kernel and the
GroupNorm kernel (a meta trace of the UNet with the launchers stubbed), the
fused temporal wrapper routes every one of those sites to the tensor-core
kernel, the GroupNorm launch plan covers every row once within the card's
limits, and both wrappers hand the C launchers the route and plan they
chose. No card needed: the stand-in launchers record shapes on meta
tensors, and a stand-in library records the C calls' arguments."""

import contextlib
import importlib
import math

import pytest
import torch

import chip_smoke
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import kernels

tfn = importlib.import_module("open_pandora_tpu_torch.ops.fused_norms")
tft = importlib.import_module("open_pandora_tpu_torch.ops.fused_temporal")
tpa = importlib.import_module("open_pandora_tpu_torch.ops.packed_attention")
BF16 = torch.bfloat16


def _trace(monkeypatch, height: int, width: int) -> tuple:
    """(GroupNorm (shape, eps, silu), fused temporal (shape, heads, whether
    the wrapper's route is the tensor-core kernel)) of one bf16 CFG eval of
    PandoraConfig()'s UNet on the meta device, on the fused route."""
    gn, ft = set(), set()

    def gn_stub(x, w, b, *, num_groups, eps, silu):
        tfn.check_shapes(x, w, b, num_groups)
        gn.add((tuple(x.shape), eps, silu))
        return torch.empty_like(x)

    def ft_stub(y, *params, heads, eps):
        tft.check_shapes(y, params, heads)
        ft.add((tuple(y.shape), heads,
                tft.tensor_core_route(y, params[5], params[6], heads)))
        return torch.empty_like(y)

    monkeypatch.setattr(tfn, "_gn_cuda", gn_stub)
    monkeypatch.setattr(tft, "_fused_temporal_cuda", ft_stub)
    monkeypatch.setattr(tpa, "_packed_cuda",
                        lambda q, streams, gate, **kw: torch.empty_like(q))
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    cfg = tcfg.PandoraConfig().unet
    with torch.device("meta"):
        model = tunet.UNetModel(cfg).to(BF16)
    model.eval()
    t = cfg.temporal_length
    x = torch.empty(2, t, height // 8, width // 8, cfg.in_channels,
                    dtype=BF16, device="meta")
    ctx = torch.empty(2, cfg.text_context_len + t * cfg.img_tokens_per_frame,
                      cfg.context_dim, dtype=BF16, device="meta")
    with torch.no_grad():
        model(x, torch.zeros(2, dtype=torch.int64, device="meta"), ctx)
    return gn, ft


@pytest.mark.parametrize("height,width", [(320, 512), (576, 1024)])
def test_phase3_holds_every_traced_shape(monkeypatch, height, width):
    gn, ft = _trace(monkeypatch, height, width)
    assert gn == set(chip_smoke.unet_group_norms(height // 8, width // 8))
    assert gn <= set(chip_smoke.group_norm_cases())
    assert {(shape, heads) for shape, heads, _ in ft} <= set(
        chip_smoke.FUSED_TEMPORAL_CASES)
    # every traced row-4 site runs the tensor-core kernel
    assert len(ft) == 3 and all(tc for _, _, tc in ft)


def test_phase3_reaches_every_route():
    """Row 4's two kernels each have phase-3 cases, and so do the edges of
    row 5's launch plan: a ragged last block of pass 1 and of pass 2, and
    one row a pass-1 block."""
    ft_routes = set()
    for shape, heads in chip_smoke.FUSED_TEMPORAL_CASES:
        y = torch.empty(shape, dtype=BF16, device="meta")
        ln = torch.empty(shape[-1], dtype=BF16, device="meta")
        ft_routes.add(tft.tensor_core_route(y, ln, ln, heads))
    assert ft_routes == {True, False}
    plans = [(math.prod(shape[1:-1]), _plan(shape))
             for shape, _, _ in chip_smoke.group_norm_cases()]
    assert any(rows % p.per for rows, p in plans)
    assert any(p.per % p.chunk_rows for _, p in plans)
    assert any(p.per == 1 for _, p in plans)


def _plan(shape):
    n, c = shape[0], shape[-1]
    return tfn.launch_plan(n, math.prod(shape[1:-1]), c)


def _covers_once(per: int, blocks: int, rows: int) -> bool:
    """Blocks b take rows [b per, min(rows, (b + 1) per)): together every
    row once, and no block past the last row."""
    return per > 0 and blocks * per >= rows > (blocks - 1) * per


@pytest.mark.parametrize("shape", sorted(
    {shape for shape, _, _ in chip_smoke.group_norm_cases()}
    | {(2, 40960, 1280), (32, 1, 64), (1, 7, 4096)}))
def test_group_norm_plan_fits_the_card(shape):
    n, c = shape[0], shape[-1]
    rows = math.prod(shape[1:-1])
    plan = _plan(shape)
    vc = c // 8
    assert plan.threads % 32 == 0 and vc <= plan.threads <= 1024
    # the kernel's warp merges take at most 256 parts
    assert plan.threads // vc * (c // 32) <= 256
    # pass 1: splits of `per` rows; pass 2: each split in chunks
    assert _covers_once(plan.per, plan.splits, rows)
    assert plan.splits <= 256
    assert _covers_once(plan.chunk_rows, plan.chunks, plan.per)
    # a pass-1 block's shared memory (csrc/group_norm_silu.cu
    # stats_smem_bytes): the block merge's per-thread moments, or the
    # sample's mean, 1 / sd, scale and shift; pass 2's is 2 C floats
    rt = plan.threads // vc
    assert 4 * max(rt * (2 * c + 1), 2 * 32 + 2 * c) <= 232448
    grids = [n * plan.splits, n * plan.splits * plan.chunks]
    if n * rows >= tfn.SMS:
        assert min(grids) >= tfn.SMS, grids


@pytest.mark.parametrize("shape,heads", [((2, 16, 5, 128), 2),
                                         ((3, 16, 128), 2)])
def test_eager_yardstick_computes_row_4(shape, heads):
    """chip_smoke's `eager_ms` chain (F.layer_norm, F.linear, SDPA over t)
    is the kernel's function: in fp32 it matches the plain version."""
    gen = torch.Generator().manual_seed(0)
    y, params = chip_smoke.fused_temporal_inputs(shape, gen, "cpu")
    y, params = y.float(), [p.float() for p in params]
    want = tft.fused_temporal_plain(y, *params, heads=heads)
    got = chip_smoke.fused_temporal_eager(y, *params, heads=heads)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= 1e-4


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
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    return lib


@pytest.mark.parametrize("shape,heads,offset,route", [
    ((2, 16, 3, 320), 5, 0, 1),     # a UNet width: the tensor-core kernel
    ((3, 16, 512), 8, 0, 1),        # a 3-D (B, t, c) stream
    ((2, 16, 3, 256), 8, 0, 0),     # head width 32: the mma.sync kernel
    ((2, 16, 3, 320), 5, 4, 0),     # y 8 bytes off 16-byte alignment
])
def test_fused_temporal_wrapper_passes_its_route(library, shape, heads,
                                                 offset, route):
    """The wrapper's route (tensor_core_route) is the one the C launcher
    gets, in the place its signature has for it."""
    y, params = chip_smoke.fused_temporal_inputs(
        shape, torch.Generator().manual_seed(0), "cpu")
    if offset:
        y = torch.empty(y.numel() + offset, dtype=BF16)[offset:] \
            .view(shape).copy_(y)
    tft._fused_temporal_cuda(y, *params, heads=heads, eps=1e-5)
    (name, args), = library.calls
    assert len(args) == len(kernels._SIGNATURES[name])
    # y .. o, then b, t, hw, c, heads, route
    assert args[9:15] == (shape[0], 16, shape[2] if len(shape) == 4 else 1,
                          shape[-1], heads, route)


@pytest.mark.parametrize("shape", [(32, 5, 8, 1280), (2, 16, 5, 8, 1280),
                                   (3, 1000, 96)])
def test_group_norm_wrapper_passes_its_plan(library, shape):
    """The wrapper hands the C launcher launch_plan's geometry, in the
    order of its signature."""
    c = shape[-1]
    x = torch.randn(*shape).to(BF16)
    w, b = torch.ones(c, dtype=BF16), torch.zeros(c, dtype=BF16)
    tfn._gn_cuda(x, w, b, num_groups=32, eps=1e-5, silu=True)
    (name, args), = library.calls
    assert len(args) == len(kernels._SIGNATURES[name])
    n, rows = shape[0], math.prod(shape[1:-1])
    # x, w, bias, scratch, out, then N, L, C, G and the plan
    assert args[5:14] == (n, rows, c, 32, *_plan(shape))
