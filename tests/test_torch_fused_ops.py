"""PyTorch port, the JAX package's default bf16 eval route: the plain
versions of the GroupNorm+SiLU, packed attention and fused temporal
attention kernels against the Pallas kernels (interpreter mode on the CPU),
the port's gates against the JAX gates at every product site, and the
routing that keeps fp32, training and CPU tensors off the kernels (traced
on the meta device, where a kernel wrapper is observable without a card)."""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import open_pandora_tpu.models.unet3d as junet
import open_pandora_tpu.ops.fused_norms as jfn
import open_pandora_tpu.ops.fused_temporal as jft
import open_pandora_tpu.ops.packed_attention as jpa
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import kernels
from open_pandora_tpu_torch.ops import packed_attention as tpa
from open_pandora_tpu_torch.ops.attention import attention_route
from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
from open_pandora_tpu_torch.ops.fused_temporal import (
    fused_temporal_self_attention)
from open_pandora_tpu_torch.ops.norms import group_norm
from open_pandora_tpu_torch.ops.packed_attention import (
    dual_cross_attention_packed, packed_attention_eligible,
    self_attention_packed)

tdca = importlib.import_module(
    "open_pandora_tpu_torch.ops.dual_cross_attention")
tfn = importlib.import_module("open_pandora_tpu_torch.ops.fused_norms")
tft = importlib.import_module("open_pandora_tpu_torch.ops.fused_temporal")
JD = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    # jfn.pl, jpa.pl and jft.pl are one module
    monkeypatch.setattr(jfn.pl, "pallas_call",
                        functools.partial(jfn.pl.pallas_call, interpret=True))


def _both(a, dtype):
    return torch.from_numpy(a).to(dtype), jnp.asarray(a).astype(JD[dtype])


def _err(out, ref) -> float:
    return float(np.abs(out.float().numpy()
                        - np.asarray(ref.astype(jnp.float32))).max())


def _tol(dtype, ref, fp32_tol):
    """fp32: summation order only. bf16: both sides round the output once,
    and a last-bit difference of an intermediate can move it by one bf16
    step, 2^-8 to 2^-7 of the largest |value|; bound 2^-7 of it."""
    if dtype == F32:
        return fp32_tol
    return 2.0 ** -7 * float(np.abs(np.asarray(ref.astype(jnp.float32))).max())


# -- plain versions against the Pallas kernels -----------------------------------


@pytest.mark.parametrize("shape,groups,silu,dtype,eps,loc", [
    ((3, 8, 16, 64), 32, True, F32, 1e-5, 0.0),      # ResBlock-like
    ((2, 4, 6, 8, 64), 16, False, F32, 1e-6, 1.0),   # (b, t, h, w, c)
    ((2, 20, 32, 320), 32, True, BF16, 1e-5, 0.0),   # UNet level-0 width
    ((2, 4, 8, 8, 128), 32, False, BF16, 1e-6, 1.0),
])
def test_group_norm_plain_matches_pallas(shape, groups, silu, dtype, eps,
                                         loc):
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + loc).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    b = (0.05 * rng.standard_normal(c)).astype(np.float32)
    (tx, jx), (tw, jw), (tb, jb) = _both(x, dtype), _both(w, dtype), \
        _both(b, dtype)
    ref = jfn.fused_group_norm_silu(jx, jw, jb, num_groups=groups, eps=eps,
                                    silu=silu, force=True)
    out = fused_group_norm_silu(tx, tw, tb, num_groups=groups, eps=eps,
                                silu=silu)
    assert out.dtype == dtype and out.shape == shape
    # fp32: the Pallas kernel's E[x^2] - mu^2 against two-pass statistics
    assert _err(out, ref) <= _tol(dtype, ref, 2e-5)
    # the wrapper on a CPU tensor is the plain version
    assert torch.equal(out, group_norm(tx, tw, tb, num_groups=groups,
                                       eps=eps, silu=silu))


@pytest.mark.parametrize("b,n,m,heads,hd,dtype", [
    (2, 640, 640, 5, 320, F32),      # level-1 width, heads straddle lanes
    (1, 600, 300, 2, 128, BF16),     # ragged N and M
    (2, 640, 640, 5, 320, BF16),
])
def test_self_packed_plain_matches_pallas(b, n, m, heads, hd, dtype):
    rng = np.random.default_rng(1)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, hd), (b, m, hd), (b, m, hd))]
    (tq, jq), (tk, jk), (tv, jv) = (_both(a, dtype) for a in arrs)
    ref = jpa.self_attention_packed(jq, jk, jv, heads=heads)
    out = self_attention_packed(tq, tk, tv, heads=heads)
    assert out.dtype == dtype and out.shape == (b, n, hd)
    assert _err(out, ref) <= _tol(dtype, ref, 1e-5)


@pytest.mark.parametrize("b,n,mt,mi,heads,hd,gate,dtype", [
    (2, 640, 77, 16, 5, 320, 1.37, F32),    # attn2: 77 text + 16 image keys
    (1, 600, 100, 130, 2, 128, 0.25, BF16),  # ragged everything
    (2, 640, 77, 16, 5, 320, 1.0, BF16),
])
def test_dual_packed_plain_matches_pallas(b, n, mt, mi, heads, hd, gate,
                                          dtype):
    rng = np.random.default_rng(2)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, n, hd), (b, mt, hd), (b, mt, hd), (b, mi, hd),
                      (b, mi, hd))]
    both = [_both(a, dtype) for a in arrs]
    ref = jpa.dual_cross_attention_packed(*[j for _, j in both],
                                          jnp.asarray(gate, jnp.float32),
                                          heads=heads)
    out = dual_cross_attention_packed(*[t for t, _ in both], gate,
                                      heads=heads)
    assert _err(out, ref) <= _tol(dtype, ref, 1e-5)
    # a gate held in a tensor (the learnable tanh gate) gives the same
    assert torch.equal(out, dual_cross_attention_packed(
        *[t for t, _ in both], torch.tensor(gate), heads=heads))


@pytest.mark.parametrize("native,shape,heads,dtype", [
    (False, (40, 16, 64), 4, F32),        # (B, t, c); JAX pads B to 64
    (True, (2, 16, 64, 64), 2, F32),      # native (b, t, hw, c)
    (False, (40, 16, 64), 4, BF16),
    (True, (2, 16, 64, 128), 2, BF16),
    (True, (2, 16, 32, 320), 5, BF16),    # main-path width: dh 64, 5 heads
])
def test_fused_temporal_plain_matches_pallas(native, shape, heads, dtype):
    rng = np.random.default_rng(3)
    c = shape[-1]
    # unit-scale residual, bias and LN shift (chip_smoke's phase-3 inputs),
    # so the branch is not lost in the rounding of a large residual
    y = rng.standard_normal(shape).astype(np.float32)
    ws = [(rng.standard_normal((c, c)) * c ** -0.5).astype(np.float32)
          for _ in range(4)]                      # JAX layout (in, out)
    vecs = [rng.standard_normal(c).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
            rng.standard_normal(c).astype(np.float32)]
    ty, jy = _both(y, dtype)
    tw = [_both(np.ascontiguousarray(w.T), dtype)[0] for w in ws]
    jw = [_both(w, dtype)[1] for w in ws]
    tv, jv = zip(*(_both(v, dtype) for v in vecs))
    fn = (jft.fused_temporal_self_attention_native if native
          else jft.fused_temporal_self_attention)
    ref = fn(jy, *jw, *jv, heads=heads)
    out = fused_temporal_self_attention(ty, *tw, *tv, heads=heads)
    assert out.dtype == dtype and out.shape == shape
    # fp32: 1e-5 on outputs of mean magnitude about 1.5
    assert _err(out, ref) <= _tol(dtype, ref, 1e-5)


# -- chip_smoke's phase-3 rule catches a wrong kernel ------------------------


@pytest.mark.parametrize("fault", [None, "bo", "ln_b", "wo"])
def test_phase3_temporal_bound_catches_faults(fault):
    """chip_smoke's phase-3 rule on its own fused temporal inputs, with a
    plain version standing in for the kernel: the faithful one is within
    the bound, one that drops the out-projection bias, the LN shift or the
    out-projection is not."""
    gen = torch.Generator().manual_seed(0)
    y, params = chip_smoke.fused_temporal_inputs((2, 16, 37, 64), gen, "cpu")
    ref32 = tft.fused_temporal_plain(y.float(), *[p.float() for p in params],
                                     heads=2)
    plain = tft.fused_temporal_plain(y, *params, heads=2)
    names = ("wq", "wk", "wv", "wo", "bo", "ln_w", "ln_b")
    kern = [torch.zeros_like(p) if n == fault else p
            for n, p in zip(names, params)]
    out = tft.fused_temporal_plain(y, *kern, heads=2)
    err, bound = chip_smoke._kernel_bound(out, plain, ref32)
    assert (err <= bound) == (fault is None), (err, bound)


@pytest.mark.parametrize("gate,kernel_gate", [(0.6, 0.6), (0.6, 1.0),
                                              (1.37, 1.0)])
def test_phase3_packed_bound_catches_wrong_gate(gate, kernel_gate):
    """The same rule on a dual packed case: a kernel that applies the
    wrong gate to the image stream is out of bounds."""
    gen = torch.Generator().manual_seed(1)
    q, kt, vt, ki, vi = (torch.randn(2, rows, 128, generator=gen).to(BF16)
                         for rows in (600, 77, 77, 16, 16))
    streams = [(kt, vt), (ki, vi)]
    ref32 = tpa.packed_attention_plain(
        q.float(), [(k.float(), v.float()) for k, v in streams], gate,
        heads=2)
    plain = tpa.packed_attention_plain(q, streams, gate, heads=2)
    out = tpa.packed_attention_plain(q, streams, kernel_gate, heads=2)
    err, bound = chip_smoke._kernel_bound(out, plain, ref32)
    assert (err <= bound) == (gate == kernel_gate), (err, bound)


# -- gates against the JAX gates --------------------------------------------


# (tokens, packed width, heads) of every spatial attention level at
# 320x512 (latent 40x64) and 576x1024 (latent 72x128), head width 64
PRODUCT_LEVELS = [(2560, 320, 5), (640, 640, 10), (160, 1280, 20),
                  (9216, 320, 5), (2304, 640, 10), (576, 1280, 20)]


@pytest.mark.parametrize("n,hd,heads", PRODUCT_LEVELS)
def test_packed_gate_matches_jax(n, hd, heads):
    for ms in ((n,), (77,), (77, 16), (77, 256)):
        assert packed_attention_eligible(n, ms, heads, hd) == \
            jpa.packed_attention_eligible(n, ms, heads, hd), ms


# temporal transformer sites (t, dim = inner): 320/640/1280 channels and
# init_attn's 8 x 64, at both resolutions (t = 16 at both)
@pytest.mark.parametrize("t,dim", [(16, 320), (16, 512), (16, 640),
                                   (16, 1280), (32, 640), (33, 320)])
def test_temporal_gate_matches_jax(monkeypatch, t, dim):
    monkeypatch.setattr(junet, "_fused_available", lambda: True)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    want = junet._fused_temporal_ok(t, dim, dim, jnp.bfloat16, True)
    with torch.device("meta"):
        block = tunet.BasicTransformerBlock(dim, dim // 64, 64,
                                            fused_temporal=True).eval()
    x = torch.empty(1, t, dim, dtype=BF16, device="meta")
    assert tunet.fused_temporal_ok(block, x, t, dim, dim) == want
    # the gate's other terms: fp32 and training stay off the kernel
    assert not tunet.fused_temporal_ok(block, x.float(), t, dim, dim)
    assert not tunet.fused_temporal_ok(block.train(), x, t, dim, dim)


# -- routing of the UNet, traced on the meta device --------------------------


def _spy_unet(monkeypatch):
    """Record every launch the fused kernels' wrappers would make and every
    dispatcher route, on meta tensors (no data, no card)."""
    calls = []

    # each stand-in runs the wrapper's own shape checks, so every site of
    # the traced model is one its kernel takes
    def gn(x, w, b, *, num_groups, **kw):
        calls.append("group_norm")
        tfn.check_shapes(x, w, b, num_groups)
        return torch.empty_like(x)

    def packed(q, streams, gate, *, heads, **kw):
        regime = tpa.packed_regime(q.shape[1],
                                   [k.shape[1] for k, _ in streams], heads)
        calls.append("packed_multi" if regime == "multi" else "packed")
        tpa.check_shapes(q, streams, heads)
        return torch.empty_like(q)

    def dual(q, kt, vt, ki, vi, gate):
        calls.append("dual_cross")
        tdca.check_shapes(q, kt, vt, ki, vi)
        return torch.empty_like(q)

    def fused_temporal(y, *params, heads, **kw):
        calls.append("fused_temporal")
        tft.check_shapes(y, params, heads)
        return torch.empty_like(y)

    monkeypatch.setattr(tfn, "_gn_cuda", gn)
    monkeypatch.setattr(tpa, "_packed_cuda", packed)
    monkeypatch.setattr(tdca, "_dual_cuda", dual)
    monkeypatch.setattr(tft, "_fused_temporal_cuda", fused_temporal)
    real_attention = tunet.attention

    def attention(q, k, v, **kw):
        # the route the dispatcher takes on a CUDA device
        calls.append(attention_route(
            q.shape, k.shape, causal=kw.get("causal", False),
            masked=kw.get("mask") is not None, on_device=True))
        return real_attention(q, k, v, **kw)
    monkeypatch.setattr(tunet, "attention", attention)
    return calls


def _meta_eval(cfg, dtype, height=320, width=512, train=False):
    with torch.device("meta"):
        model = tunet.UNetModel(cfg).to(dtype)
    model.train(train)
    t, hz, wz = cfg.temporal_length, height // 8, width // 8
    x = torch.empty(2, t, hz, wz, cfg.in_channels, dtype=dtype,
                    device="meta")
    ctx = torch.empty(2, cfg.text_context_len + t * cfg.img_tokens_per_frame,
                      cfg.context_dim, dtype=dtype, device="meta")
    steps = torch.zeros(2, dtype=torch.int64, device="meta")
    with torch.no_grad():
        out = model(x, steps, ctx)
    assert out.shape == (2, t, hz, wz, cfg.out_channels)


def test_full_width_eval_routes_as_predicted(monkeypatch):
    """PandoraConfig() at 320x512, bf16 eval on the fused route: launches
    per CFG eval equal chip_smoke's prediction (packed 20, fused temporal
    22, small attention 12, flash 0, GroupNorm 166; no conv kernel: the
    conv routes are opt-in)."""
    calls = _spy_unet(monkeypatch)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    cfg = tcfg.PandoraConfig()
    _meta_eval(cfg.unet, BF16)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    want = chip_smoke.predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                                         fused=True)["per_eval"]
    assert got == want == {"flash": 0, "flash_bwd": 0, "small": 12,
                           "small_bwd": 0, "packed": 20, "packed_multi": 0,
                           "dual_cross": 0, "fused_temporal": 22,
                           "group_norm": 166, "conv3x3": 0,
                           "conv3x3_fused": 0, "fused_geglu": 0}


@pytest.mark.parametrize("dtype,train,available", [
    (F32, False, True),     # the golden fp32 mode
    (BF16, True, True),     # training
    (BF16, False, False),   # a tensor the fused kernels do not serve
])
def test_fused_kernels_stay_off(monkeypatch, dtype, train, available):
    """fp32, training mode and tensors off the fused device never reach the
    new kernels' wrappers; they take the unfused route."""
    calls = _spy_unet(monkeypatch)
    monkeypatch.setattr(kernels, "fused_available", lambda x: available)
    cfg = chip_smoke.narrow_config()
    _meta_eval(cfg.unet, dtype, train=train)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    want = chip_smoke.predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                                         fused=False)["per_eval"]
    assert got == want
    assert want["group_norm"] == want["packed"] == want["fused_temporal"] \
        == 0 and want["flash"] > 0 and want["small"] > 0


def test_wrappers_refuse_other_devices():
    x = torch.empty(2, 8, 64, dtype=BF16, device="meta")
    w = torch.empty(64, dtype=BF16, device="meta")
    with pytest.raises(ValueError):
        tfn._gn_cuda(x, w, w, num_groups=32, eps=1e-5, silu=False)
    with pytest.raises(ValueError):
        self_attention_packed(x, x, x, heads=2)
    with pytest.raises(ValueError):
        fused_temporal_self_attention(x, *[x[0]] * 4, w, w, w, heads=2)
