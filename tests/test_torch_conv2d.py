"""PyTorch port, the UNet's opt-in 3x3 conv routes: the port's gates against
the JAX gates under every flag combination, the plain versions of the direct
and fused conv kernels against the Pallas kernels (interpreter mode on the
CPU), the nine-dot formulation, the GroupNorm fold, and a ResBlock on its
fused conv route against the JAX ResBlock on its own."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.core import unfreeze

import open_pandora_tpu.models.unet3d as junet
import open_pandora_tpu.ops.conv2d as jc2
import chip_smoke
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.core.convert import _resblock_unet
from open_pandora_tpu_torch.models import layers as tlayers
from open_pandora_tpu_torch.models.layers import GroupNorm32, SConv3x3
from open_pandora_tpu_torch.models.unet3d import ResBlock
from open_pandora_tpu_torch.ops import conv2d as tc2
from open_pandora_tpu_torch.ops import kernels
from test_torch_fused_ops import BF16, F32, _meta_eval, _spy_unet

# the module, not the function that open_pandora_tpu.ops exports by its name
jatt = importlib.import_module("open_pandora_tpu.ops.attention")
FLAG_NAMES = ("PANDORA_ENABLE_PCONV", "PANDORA_ENABLE_PCONV2",
              "PANDORA_DISABLE_PCONV", "PANDORA_PCONV_ONLY",
              "PANDORA_CONV_CENSUS", "PANDORA_SPATIAL_DOT")


@pytest.fixture(autouse=True)
def _clean_flags(monkeypatch):
    """Both packages read the same environment; no override, no flag left
    set by another test."""
    for name in FLAG_NAMES:
        monkeypatch.delenv(name, raising=False)
        flags.clear_flag(name)


@pytest.fixture
def _interpret_pallas(monkeypatch):
    monkeypatch.setattr(jc2.pl, "pallas_call",
                        functools.partial(jc2.pl.pallas_call, interpret=True))


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


# -- gates --------------------------------------------------------------------

# every routed site of PandoraConfig()'s UNet at 320x512 and 576x1024, the
# sites the gates refuse there (10x16, 5x8, and 9x16 / 18x32 below 512 or
# not fitting), and shapes that fail one rule each (c, co or w not a
# multiple of 8, h * w < 512, slabs too large whole and split)
GATE_SHAPES = sorted({
    (40, 64, 8, 320), (40, 64, 320, 320), (40, 64, 640, 320),
    (40, 64, 640, 640), (40, 64, 960, 320), (20, 32, 320, 640),
    (20, 32, 640, 640), (20, 32, 960, 640), (20, 32, 1280, 640),
    (20, 32, 1280, 1280), (20, 32, 1920, 640), (10, 16, 640, 1280),
    (10, 16, 1280, 1280), (10, 16, 1920, 1280), (10, 16, 2560, 1280),
    (5, 8, 1280, 1280), (5, 8, 2560, 1280),
    (72, 128, 8, 320), (72, 128, 320, 320), (72, 128, 640, 320),
    (72, 128, 640, 640), (72, 128, 960, 320), (36, 64, 320, 640),
    (36, 64, 640, 640), (36, 64, 960, 640), (36, 64, 1280, 640),
    (36, 64, 1280, 1280), (36, 64, 1920, 640), (18, 32, 640, 1280),
    (18, 32, 1280, 1280), (18, 32, 1920, 1280), (18, 32, 2560, 1280),
    (9, 16, 1280, 1280), (9, 16, 2560, 1280),
    (40, 64, 12, 320), (40, 64, 320, 324), (40, 60, 320, 320),
    (16, 31, 64, 64), (16, 32, 64, 64), (16, 32, 8, 64), (8, 16, 128, 128),
    (144, 256, 1280, 1280), (144, 256, 320, 320), (72, 128, 2560, 1280),
})

FLAG_SETS = [
    {},
    {"PANDORA_ENABLE_PCONV": "1"},
    {"PANDORA_ENABLE_PCONV2": "1"},
    {"PANDORA_ENABLE_PCONV": "1", "PANDORA_ENABLE_PCONV2": "true"},
    {"PANDORA_ENABLE_PCONV": "1", "PANDORA_ENABLE_PCONV2": "1",
     "PANDORA_DISABLE_PCONV": "1"},
    {"PANDORA_PCONV_ONLY": "40x64x320x320,20x32x1920x640,10x16x1280x1280"},
    {"PANDORA_PCONV_ONLY": "72x128x960x320", "PANDORA_ENABLE_PCONV": "0"},
    {"PANDORA_PCONV_ONLY": "40x64x320x320", "PANDORA_DISABLE_PCONV": "yes"},
    {"PANDORA_ENABLE_PCONV2": "off", "PANDORA_ENABLE_PCONV": "no"},
]


@pytest.mark.parametrize("env", FLAG_SETS)
def test_gates_match_jax(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for shape in GATE_SHAPES:
        assert tc2.conv3x3_eligible(*shape) == jc2.conv3x3_eligible(*shape), \
            (shape, env)
        assert (tc2.conv3x3_fused_eligible(*shape)
                == jc2.conv3x3_fused_eligible(*shape)), (shape, env)


def test_override_beats_environment(monkeypatch):
    monkeypatch.setenv("PANDORA_ENABLE_PCONV2", "1")
    assert tc2.conv3x3_fused_eligible(40, 64, 320, 320)
    with flags.overridden(ENABLE_PCONV2=False):
        assert not tc2.conv3x3_fused_eligible(40, 64, 320, 320)
        assert flags.snapshot() == {}
    assert flags.snapshot() == {"PANDORA_ENABLE_PCONV2": True}
    with pytest.raises(KeyError):
        flags.set_flag("PANDORA_STREAMING_GN", True)    # not a port flag


# -- plain versions against the Pallas kernels ---------------------------------

# the last two: C = 8 (the input conv's width) into a Co off the kernel's
# 160-channel tile, and one whole 64-channel chunk into the same Co
@pytest.mark.parametrize("shape", [(2, 8, 16, 32, 32), (1, 9, 13, 24, 40),
                                   (2, 16, 8, 8, 64), (2, 6, 10, 8, 72),
                                   (1, 9, 13, 64, 72)])
def test_direct_plain_matches_pallas(_interpret_pallas, shape):
    B, H, W, C, Co = shape
    x, w, b = _rng_arrays(0, (B, H, W, C), (3, 3, C, Co), (Co,))
    w *= 0.1
    ref = jc2.conv3x3_nhwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    out = tc2.conv3x3_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("prologue,residual,shift", [
    (True, True, 0.0), (True, False, 0.0), (False, True, 0.0),
    (False, False, 0.0),
    # a large shift: a prologue applied to the zero border would read
    # silu(4) ~ 3.9 at every edge pixel instead of 0
    (True, True, 4.0)])
def test_fused_plain_matches_pallas(_interpret_pallas, prologue, residual,
                                    shift):
    B, H, W, C, Co = 2, 8, 16, 32, 48
    x, w, b, a, s, r = _rng_arrays(1, (B, H, W, C), (3, 3, C, Co), (Co,),
                                   (B, C), (B, C), (B, H, W, Co))
    w *= 0.1
    a = 1.0 + 0.2 * a
    s = shift + 0.5 * s
    kw_j = dict(scale=jnp.asarray(a) if prologue else None,
                shift=jnp.asarray(s) if prologue else None,
                residual=jnp.asarray(r) if residual else None)
    ref = jc2.conv3x3_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            **kw_j)
    kw_t = {k: None if v is None else torch.from_numpy(np.array(v))
            for k, v in kw_j.items()}
    out = tc2.conv3x3_fused(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert out.dtype == torch.float32 and out.shape == (B, H, W, Co)


# the fused form at the kernel's edge widths, prologue, residual and a
# shifted fold: C = 8 into Co = 72 (off the 160-channel tile), and one
# whole 64-channel chunk into the same Co
@pytest.mark.parametrize("shape", [(2, 6, 10, 8, 72), (1, 9, 13, 64, 72)])
def test_fused_plain_matches_pallas_edge_widths(_interpret_pallas, shape):
    B, H, W, C, Co = shape
    x, w, b, a, s, r = _rng_arrays(6, (B, H, W, C), (3, 3, C, Co), (Co,),
                                   (B, C), (B, C), (B, H, W, Co))
    w *= 0.1
    a = 1.0 + 0.2 * a
    s = 4.0 + 0.5 * s
    ref = jc2.conv3x3_fused(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            scale=jnp.asarray(a), shift=jnp.asarray(s),
                            residual=jnp.asarray(r))
    out = tc2.conv3x3_fused(*map(torch.from_numpy, (x, w, b, a, s, r)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)


# -- nine-dot and the library conv ---------------------------------------------

def _library_conv(x, w, b):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b,
                    padding=1).permute(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 8, 16, 16, 24), (1, 5, 7, 8, 16)])
def test_ninedot_matches_library_conv(shape):
    B, H, W, C, Co = shape
    x, w, b = (torch.from_numpy(a) for a in _rng_arrays(
        2, (B, H, W, C), (3, 3, C, Co), (Co,)))
    out = tc2.conv3x3_ninedot(x, w, b)
    torch.testing.assert_close(out, _library_conv(x, w, b), atol=1e-4,
                               rtol=1e-4)


def test_spatial_dot_route(monkeypatch):
    conv = SConv3x3(16, 24).eval()
    x = torch.from_numpy(_rng_arrays(3, (2, 8, 16, 16))[0])
    with torch.no_grad():
        ref = conv(x)
        calls = []
        real = tlayers.conv3x3_ninedot
        monkeypatch.setattr(tlayers, "conv3x3_ninedot",
                            lambda *a: calls.append(1) or real(*a))
        with flags.overridden(SPATIAL_DOT=True):
            out = conv(x, fast=True)
    assert calls == [1]
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_census_records_sites():
    tc2.CENSUS.clear()
    conv = SConv3x3(8, 16).eval()
    with torch.no_grad(), flags.overridden(CONV_CENSUS=True):
        conv(torch.zeros(1, 4, 6, 8))
    conv(torch.zeros(1, 5, 6, 8))                   # census off: no entry
    assert tc2.CENSUS == {(4, 6, 8, 16)}
    tc2.CENSUS.clear()


# -- GroupNorm fold ------------------------------------------------------------

@pytest.mark.parametrize("with_extra", [False, True])
def test_fold_matches_jax(with_extra):
    B, H, W, C = 3, 5, 7, 64
    x, g, b, e = _rng_arrays(4, (B, H, W, C), (C,), (C,), (B, C))
    x = 2.0 * x + 0.5
    g = 1.0 + 0.1 * g
    gn = junet.GroupNorm32(eps=1e-5)
    a_j, b_j = gn.apply({"params": {"scale": jnp.asarray(g),
                                    "bias": jnp.asarray(b)}},
                        jnp.asarray(x), stats_only=True,
                        extra=jnp.asarray(e) if with_extra else None)
    tg = GroupNorm32(C, 1e-5)
    tg.load_state_dict({"weight": torch.from_numpy(g),
                        "bias": torch.from_numpy(b)})
    with torch.no_grad():
        a_t, b_t = tg.fold(torch.from_numpy(x),
                           torch.from_numpy(e) if with_extra else None)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(b_t.numpy(), np.asarray(b_j), atol=1e-5,
                               rtol=1e-5)


# -- a ResBlock on its fused conv route -----------------------------------------

@pytest.mark.parametrize("in_ch,out_ch", [(64, 64), (96, 64)])
def test_resblock_fused_route_matches_jax(monkeypatch, _interpret_pallas,
                                          in_ch, out_ch):
    B, H, W, E = 2, 16, 32, 32           # h * w = 512: the gate admits it
    x, emb = _rng_arrays(5, (B, H, W, in_ch), (B, E))
    block = junet.ResBlock(out_ch=out_ch)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(emb), 1)
    rng = np.random.default_rng(6)

    def fill(s):
        if len(s.shape) >= 2:
            return (rng.standard_normal(s.shape)
                    / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)
    params = unfreeze(jax.tree_util.tree_map(fill, shapes))["params"]
    for norm in ("in_norm", "out_norm"):
        params[norm]["scale"] = params[norm]["scale"] + 1.0
    monkeypatch.setenv("PANDORA_ENABLE_PCONV2", "1")
    monkeypatch.setattr(jatt, "_on_tpu", lambda: True)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    counts = {"jax": 0, "port": 0}
    real_call = jc2.pl.pallas_call

    def call(kernel, *a, **kw):
        if getattr(kernel, "func", kernel).__name__ == "_fused_kernel":
            counts["jax"] += 1
        return real_call(kernel, *a, **kw)
    monkeypatch.setattr(jc2.pl, "pallas_call", call)
    real_fused = tlayers.conv3x3_fused

    def spy(*a, **kw):
        counts["port"] += 1
        return real_fused(*a, **kw)
    monkeypatch.setattr(tlayers, "conv3x3_fused", spy)

    ref = block.apply({"params": params}, jnp.asarray(x), jnp.asarray(emb),
                      1)
    port = ResBlock(in_ch, out_ch, E, use_temporal_conv=False).eval()
    flat = {}
    _resblock_unet(flat, "r", params)
    port.load_state_dict({k[2:]: torch.from_numpy(v)
                          for k, v in flat.items()}, strict=True)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(emb), 1)
    assert counts == {"jax": 2, "port": 2}
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=2e-4)


# -- the full-width UNet's conv routes, traced on the meta device ----------------

@pytest.mark.parametrize("flag,height,width,sites,gn_drop,dtype", [
    pytest.param("PANDORA_ENABLE_PCONV2", 320, 512, 23, 20, BF16,
                 id="PANDORA_ENABLE_PCONV2-320-512-23-20"),
    pytest.param("PANDORA_ENABLE_PCONV", 320, 512, 23, 0, BF16,
                 id="PANDORA_ENABLE_PCONV-320-512-23-0"),
    pytest.param("PANDORA_ENABLE_PCONV2", 576, 1024, 34, 30, BF16,
                 id="PANDORA_ENABLE_PCONV2-576-1024-34-30"),
    pytest.param("PANDORA_ENABLE_PCONV2", 320, 512, 23, 0, F32,
                 id="PANDORA_ENABLE_PCONV2-320-512-fp32"),
    pytest.param("PANDORA_ENABLE_PCONV", 320, 512, 23, 0, F32,
                 id="PANDORA_ENABLE_PCONV-320-512-fp32"),
    pytest.param("PANDORA_ENABLE_PCONV2", 576, 1024, 34, 0, F32,
                 id="PANDORA_ENABLE_PCONV2-576-1024-fp32"),
])
def test_full_width_conv_routes_as_predicted(monkeypatch, flag, height, width,
                                             sites, gn_drop, dtype):
    """PandoraConfig() in eval with a conv flag: every routed site passes
    the conv kernel's shape checks (a stand-in launcher on meta tensors),
    and the launches per CFG eval equal chip_smoke's prediction: 23 conv
    sites at 320x512 and 34 at 576x1024, (72, 128, 960 -> 320) whole. In
    bf16, under PCONV2 each routed ResBlock conv takes its GroupNorm
    along; in fp32 (the unfused route) the same sites take the fp32 conv
    kernel and rows 3-5 do not launch."""
    calls = _spy_unet(monkeypatch)

    def conv(x, packed, b, scale, shift, residual, *, fused):
        name = "conv3x3_fused" if fused else "conv3x3"
        calls.append(name)
        x = x.contiguous()          # as the launcher does
        tc2.check_shapes(name, x, packed, scale, shift, residual)
        if (x.shape[1:], packed.shape[0]) == ((72, 128, 960), 320):
            calls.append("whole_960")
        return torch.empty(*x.shape[:3], packed.shape[0], dtype=x.dtype,
                           device=x.device)
    monkeypatch.setattr(tc2, "_conv_cuda", conv)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    cfg = tcfg.PandoraConfig()
    chunk = 8 if height == 320 else 2
    fused = dtype == BF16
    base = chip_smoke.predicted_launches(cfg, height, width, 1,
                                         frame_chunk=chunk,
                                         fused=fused)["per_eval"]
    monkeypatch.setenv(flag, "1")
    _meta_eval(cfg.unet, dtype, height, width)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    want = chip_smoke.predicted_launches(cfg, height, width, 1,
                                         frame_chunk=chunk,
                                         fused=fused)["per_eval"]
    assert got == want
    if not fused:
        assert got["packed"] == got["fused_temporal"] == 0
        assert got["group_norm"] == base["group_norm"] == 0
    key = "conv3x3_fused" if flag.endswith("2") else "conv3x3"
    assert got[key] == sites
    assert got["conv3x3" if key == "conv3x3_fused" else "conv3x3_fused"] == 0
    assert base["group_norm"] - got["group_norm"] == gn_drop
    assert calls.count("whole_960") == (1 if height == 576 else 0)
