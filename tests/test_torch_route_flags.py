"""PyTorch port, the switches of the default bf16 eval route
(PANDORA_DISABLE_FUSED, _FUSED_GN, _PACKED, _DUALCA, _TNATIVE): the port's
gates against the JAX package's gates under each flag set, the temporal
transformers' native stream traced in both packages, and the full-width
UNet's routes traced on the meta device under each flag."""

import importlib
import types

import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import open_pandora_tpu.models.unet3d as junet
import open_pandora_tpu.ops.dual_cross_attention as jdca
import open_pandora_tpu.ops.fused_norms as jfn
import open_pandora_tpu.ops.fused_temporal as jft
import open_pandora_tpu.ops.packed_attention as jpa
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import kernels
from test_torch_fused_ops import BF16, _meta_eval, _spy_unet

tdca = importlib.import_module(
    "open_pandora_tpu_torch.ops.dual_cross_attention")
tfn = importlib.import_module("open_pandora_tpu_torch.ops.fused_norms")
tft = importlib.import_module("open_pandora_tpu_torch.ops.fused_temporal")
tpa = importlib.import_module("open_pandora_tpu_torch.ops.packed_attention")

FLAG_NAMES = ("PANDORA_DISABLE_FUSED", "PANDORA_DISABLE_FUSED_GN",
              "PANDORA_DISABLE_PACKED", "PANDORA_DISABLE_DUALCA",
              "PANDORA_DISABLE_TNATIVE")
FLAG_SETS = [
    {},
    {"PANDORA_DISABLE_FUSED": "1"},
    {"PANDORA_DISABLE_FUSED_GN": "1"},
    {"PANDORA_DISABLE_PACKED": "1"},
    {"PANDORA_DISABLE_DUALCA": "1"},
    {"PANDORA_DISABLE_TNATIVE": "1"},
    {"PANDORA_DISABLE_PACKED": "1", "PANDORA_DISABLE_DUALCA": "true"},
    {"PANDORA_DISABLE_FUSED": "0", "PANDORA_DISABLE_FUSED_GN": "off"},
]

# attention sites of PandoraConfig()'s UNet (head width 64, 77 text and 16
# image keys) at 320x512 and 576x1024, the same at head width 80, and the
# narrow model's at head width 48: (n, key rows per stream, heads, packed
# width)
_LEVELS = ((2560, 320), (640, 640), (160, 1280), (40, 1280), (9216, 320),
           (2304, 640), (576, 1280), (144, 1280))
SITES = [
    (n, ms, c // d, c)
    for d, levels in ((64, _LEVELS), (80, _LEVELS),
                      (48, ((2560, 96), (640, 192), (160, 384))))
    for n, c in levels
    for ms in ((n,), (77, 16))
]


@pytest.fixture(autouse=True)
def _clean_flags(monkeypatch):
    """Both packages read the same environment; no override, no flag left
    set by another test."""
    for name in FLAG_NAMES:
        monkeypatch.delenv(name, raising=False)
        flags.clear_flag(name)


def _set(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)


_TPU_JAX = types.SimpleNamespace(config=types.SimpleNamespace(
    jax_default_device=types.SimpleNamespace(platform="tpu")))


def _jax_fused_available() -> bool:
    """JAX's `_fused_available` (its flag rule included) as it answers on a
    TPU: the platform it asks about is faked for the one call."""
    real = junet.jax
    junet.jax = _TPU_JAX
    try:
        return _REAL_FUSED_AVAILABLE()
    finally:
        junet.jax = real


_REAL_FUSED_AVAILABLE = junet._fused_available


@pytest.fixture
def _on_device(monkeypatch):
    """Both packages' device checks say yes: the port's CUDA check and the
    JAX TPU checks (their flag rules untouched)."""
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    monkeypatch.setattr(junet, "_fused_available", _jax_fused_available)
    monkeypatch.setattr(jfn, "_on_tpu", lambda: True)


@pytest.mark.parametrize("env", FLAG_SETS)
def test_gates_match_jax(monkeypatch, _on_device, env):
    _set(monkeypatch, env)
    for n, ms, heads, hd in SITES:
        assert (tpa.packed_attention_eligible(n, ms, heads, hd)
                == jpa.packed_attention_eligible(n, ms, heads, hd)), \
            (n, ms, heads, hd, env)
        if len(ms) == 2:
            assert (tdca.dual_cross_attention_eligible(n, *ms, hd // heads)
                    == jdca.dual_cross_attention_eligible(n, *ms,
                                                          hd // heads))
    x = torch.empty(2, 64, 320, dtype=BF16, device="meta")
    with torch.device("meta"):
        attn = tunet.CrossAttention(320, 5, 64).eval()
    assert tunet._fused_route(attn, x) == junet._fused_available(), env
    launched = []
    monkeypatch.setattr(tfn, "_gn_cuda",
                        lambda x, *a, **k: launched.append(1) or x)
    tfn.fused_group_norm_silu(x, x[0, 0], x[0, 0], silu=True)
    assert bool(launched) == jfn._fused_gn_available(), env


def _jax_temporal_layouts(shape) -> list:
    """The layouts JAX's TemporalTransformer hands its fused temporal
    kernel (4: the native stream, 3: transposed), traced abstractly with
    the kernel entry points replaced by recorders."""
    seen = []

    def record(y, *args, **kw):
        seen.append(y.ndim)
        return y
    mp = pytest.MonkeyPatch()
    mp.setattr(jft, "fused_temporal_self_attention", record)
    mp.setattr(jft, "fused_temporal_self_attention_native", record)
    try:
        model = junet.TemporalTransformer(heads=2, dim_head=32, depth=1,
                                          dtype=jnp.bfloat16)
        x = jax.ShapeDtypeStruct(shape, jnp.bfloat16)
        jax.eval_shape(lambda x: model.init_with_output(
            jax.random.PRNGKey(0), x, True), x)
    finally:
        mp.undo()
    return seen


def _torch_temporal_layouts(monkeypatch, shape) -> list:
    seen = []

    def record(y, *params, heads, **kw):
        seen.append(y.ndim)
        tft.check_shapes(y, params, heads)
        return torch.empty_like(y)
    monkeypatch.setattr(tft, "_fused_temporal_cuda", record)
    monkeypatch.setattr(tfn, "_gn_cuda", lambda x, *a, **k: x)
    with torch.device("meta"):
        model = tunet.TemporalTransformer(shape[-1], 2, 32, 1).to(BF16)
    model.eval()
    with torch.no_grad():
        model(torch.empty(*shape, dtype=BF16, device="meta"))
    return seen


@pytest.mark.parametrize("env,layouts", [
    ({}, [4, 4]),
    ({"PANDORA_DISABLE_TNATIVE": "1"}, [3, 3]),
    ({"PANDORA_DISABLE_TNATIVE": "no"}, [4, 4]),
    ({"PANDORA_DISABLE_FUSED": "1"}, []),
])
def test_temporal_layout_matches_jax(monkeypatch, _on_device, env, layouts):
    """The layout each package hands its fused temporal kernel (attn1 and
    attn2 of one block): the native (b, t, h*w, c) stream, the transposed
    (b*h*w, t, c) one under PANDORA_DISABLE_TNATIVE, no kernel under
    PANDORA_DISABLE_FUSED. h*w = 32, where the JAX package's native gate
    (h*w % 32 == 0) and the port's agree."""
    _set(monkeypatch, env)
    shape = (1, 16, 4, 8, 64)
    assert _jax_temporal_layouts(shape) == layouts
    assert _torch_temporal_layouts(monkeypatch, shape) == layouts


@pytest.mark.parametrize("env", FLAG_SETS)
def test_full_width_routes_under_flags(monkeypatch, env):
    """PandoraConfig()'s UNet at 320x512 in bf16 eval, traced on the meta
    device with stand-in launchers under each flag set: the launches per
    CFG eval equal chip_smoke's prediction for the route the flags leave
    (the unfused route under PANDORA_DISABLE_FUSED, no GroupNorm kernel
    under PANDORA_DISABLE_FUSED_GN; the packed and dual gates read their
    own flags), and every fused temporal site sees the transposed stream
    under PANDORA_DISABLE_TNATIVE."""
    calls = _spy_unet(monkeypatch)
    layouts = []
    spy = tft._fused_temporal_cuda

    def temporal(y, *params, **kw):
        layouts.append(y.ndim)
        return spy(y, *params, **kw)
    monkeypatch.setattr(tft, "_fused_temporal_cuda", temporal)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    _set(monkeypatch, env)
    cfg = tcfg.PandoraConfig()
    _meta_eval(cfg.unet, BF16)
    got = {k: calls.count(k) for k in chip_smoke.KERNEL_KEYS}
    fused = not flags.flag("PANDORA_DISABLE_FUSED")
    want = chip_smoke.predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                                         fused=fused)["per_eval"]
    if flags.flag("PANDORA_DISABLE_FUSED_GN"):
        want["group_norm"] = 0
    assert got == want
    packed_off = flags.flag("PANDORA_DISABLE_PACKED") or not fused
    dual_off = flags.flag("PANDORA_DISABLE_DUALCA") or not fused
    # the 20 packed sites: 10 attn1 (flash when off) and 10 attn2 (the dual
    # kernel when only the packed one is off, else two plain attentions
    # over 77 and 16 keys)
    assert got["packed"] == (0 if packed_off else 20)
    assert got["dual_cross"] == (10 if packed_off and not dual_off else 0)
    assert got["flash"] == (10 if packed_off else 0)
    assert got["fused_temporal"] == (22 if fused else 0)
    assert set(layouts) <= ({3} if flags.flag("PANDORA_DISABLE_TNATIVE")
                            else {4})
