"""PyTorch port: the transformer block's LN3 -> GEGLU -> Linear -> residual
on the bf16 eval route as one call of the fused GEGLU feed-forward (row 13),
against the same block on the eager route, on the CPU: with
`kernels.fused_available` patched the fused route is taken and the wrapper
runs its plain version, so no card is needed. Also the kernel-layout
weights each FeedForward keeps, and the route's gate. This file imports no
JAX."""

import importlib

import pytest
import torch

from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import kernels

tfg = importlib.import_module("open_pandora_tpu_torch.ops.fused_geglu")
BF16 = torch.bfloat16


@pytest.fixture
def spy(monkeypatch):
    """The fused route on CPU tensors; counts the fused GEGLU calls and the
    eager feed-forward's GEGLU calls."""
    calls = {"fused": 0, "eager": 0}
    fused, eager = tfg.fused_geglu_ff, tunet.GEGLU.forward

    def fused_spy(*args, **kw):
        calls["fused"] += 1
        return fused(*args, **kw)

    def eager_spy(self, x):
        calls["eager"] += 1
        return eager(self, x)
    monkeypatch.setattr(tunet, "fused_geglu_ff", fused_spy)
    monkeypatch.setattr(tunet.GEGLU, "forward", eager_spy)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    return calls


def _block(dim, heads, fused_temporal=False, seed=0):
    gen = torch.Generator().manual_seed(seed)
    blk = tunet.BasicTransformerBlock(dim, heads, dim // heads,
                                      fused_temporal=fused_temporal)
    with torch.no_grad():
        for name, p in blk.named_parameters():
            p.copy_(torch.randn(p.shape, generator=gen)
                    * (p.shape[-1] ** -0.5 if p.ndim == 2 else 0.2)
                    + (1.0 if "norm" in name and "weight" in name else 0.0))
    return blk.to(BF16).eval()


def _close(got, want):
    """bf16 on both sides: the eager chain rounds h and the sum twice each,
    the fused route once; bound 2^-6 of the largest |value|."""
    assert got.shape == want.shape
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6 * scale


def _eager(monkeypatch, fn):
    with monkeypatch.context() as m:
        m.setattr(kernels, "fused_available", lambda x: False)
        return fn()


def test_spatial_block_matches_eager(monkeypatch, spy):
    blk = _block(64, 2)
    x = torch.randn(3, 40, 64, generator=torch.Generator().manual_seed(1))
    x = x.to(BF16)
    with torch.no_grad():
        got = blk(x)
        assert spy == {"fused": 1, "eager": 0}
        want = _eager(monkeypatch, lambda: blk(x))
    assert spy == {"fused": 1, "eager": 1}
    _close(got, want)


def test_native_temporal_block_matches_eager(monkeypatch, spy):
    """(b, t, hw, c) on the fused route (fused temporal attention, then the
    fused feed-forward on the native stream) against the eager route on the
    transposed (b hw, t, c) stream."""
    blk = _block(64, 2, fused_temporal=True)
    b, t, hw, c = 2, 16, 6, 64
    x = torch.randn(b, t, hw, c, generator=torch.Generator().manual_seed(2))
    x = x.to(BF16)
    with torch.no_grad():
        got = blk(x)
        assert spy == {"fused": 1, "eager": 0}
        xt = x.permute(0, 2, 1, 3).reshape(b * hw, t, c)
        want = _eager(monkeypatch, lambda: blk(xt))
    assert spy == {"fused": 1, "eager": 1}
    _close(got, want.reshape(b, hw, t, c).permute(0, 2, 1, 3))


def test_chunked_shape_runs_in_one_call(monkeypatch, spy):
    """A shape the eager path takes in chunks: the fused route makes one
    call over all rows, with the same result."""
    monkeypatch.setattr(tunet.FeedForward, "CHUNK_THRESHOLD", 2 ** 14)
    monkeypatch.setattr(tunet.FeedForward, "CHUNK_TARGET", 2 ** 13)
    blk = _block(64, 2)
    x = torch.randn(8, 20, 64, generator=torch.Generator().manual_seed(3))
    x = x.to(BF16)
    assert blk.ff.chunks(x.shape) == 8
    with torch.no_grad():
        got = blk.feed_forward(x)
        assert spy == {"fused": 1, "eager": 0}
        want = _eager(monkeypatch, lambda: blk.feed_forward(x))
    assert spy == {"fused": 1, "eager": 8}
    _close(got, want)


def test_non_contiguous_stream(spy):
    """x that is not contiguous is copied once and gives the contiguous
    input's result."""
    blk = _block(64, 2)
    base = torch.randn(40, 3, 64, generator=torch.Generator().manual_seed(4))
    x = base.to(BF16).transpose(0, 1)
    assert not x.is_contiguous()
    with torch.no_grad():
        assert torch.equal(blk.feed_forward(x),
                           blk.feed_forward(x.contiguous()))


@pytest.mark.parametrize("dtype,train,available", [
    (torch.float32, False, True),     # the golden fp32 mode
    (BF16, True, True),               # training
    (BF16, False, False),             # a tensor the kernels do not serve
])
def test_other_routes_stay_eager(monkeypatch, spy, dtype, train, available):
    monkeypatch.setattr(kernels, "fused_available", lambda x: available)
    blk = _block(64, 2).to(dtype).train(train)
    x = torch.randn(2, 8, 64, dtype=dtype)
    with torch.no_grad():
        blk(x)
    assert spy == {"fused": 0, "eager": 1}


def test_kernel_weights_layout_and_rebuild():
    """w1 (c, 2 inner) with GEGLU's value columns first, w2 (inner, c);
    kept while the parameters stand, rebuilt after load_state_dict changes
    them in place."""
    blk = _block(64, 2)
    ff = blk.ff
    w1, b1, w2, b2 = ff.kernel_weights(BF16)
    proj, down = ff.net[0].proj, ff.net[2]
    assert torch.equal(w1, proj.weight.t()) and w1.is_contiguous()
    assert torch.equal(w2, down.weight.t()) and w2.is_contiguous()
    assert torch.equal(b1, proj.bias) and torch.equal(b2, down.bias)
    # value columns first: h = x w1 + b1 chunks as GEGLU's projection does
    x = torch.randn(5, 64).to(BF16)
    v, g = (x @ w1 + b1).chunk(2, dim=-1)
    pv, pg = proj(x).chunk(2, dim=-1)
    assert (v.float() - pv.float()).abs().max() <= 2 ** -6 * pv.abs().max()
    assert ff.kernel_weights(BF16)[0] is w1
    before = [t.clone() for t in (w1, b1, w2, b2)]
    ff.load_state_dict({k: v * 2 for k, v in ff.state_dict().items()})
    after = ff.kernel_weights(BF16)
    assert after[0] is not w1
    assert torch.equal(after[0], proj.weight.t())
    assert torch.equal(after[2], down.weight.t())
    assert all(torch.equal(a, 2 * b) for a, b in zip(after, before))


def test_gate_admits_every_unet_width():
    """320, 512 (init_attn), 640 and 1280 take the kernel; a width that is
    not a multiple of 32 does not."""
    assert all(tfg.geglu_ff_eligible(c) for c in (320, 512, 640, 1280))
    assert not tfg.geglu_ff_eligible(48)
