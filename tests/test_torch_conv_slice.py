"""PyTorch port, the UNet's opt-in conv routes as a slice: one batched-CFG
UNet eval of the tiny bf16 config of test_torch_fused_slice.py (latent
16x32, so the top level's conv sites have the 512 pixels the gates ask
for), the port under PANDORA_ENABLE_PCONV and under PANDORA_ENABLE_PCONV2
against the JAX package under the same flag on its fused route (its conv,
GroupNorm, packed and fused temporal Pallas kernels in interpreter mode),
and both sides' conv-kernel calls counted site for site."""

import functools
import importlib

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import open_pandora_tpu.models.unet3d as junet
import open_pandora_tpu.ops.conv2d as jc2
import open_pandora_tpu.ops.fused_norms as jfn
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.core.convert import state_dict_from_jax
from open_pandora_tpu_torch.eval.inference import build_model
from open_pandora_tpu_torch.models import layers as tlayers
from open_pandora_tpu_torch.ops import kernels
from test_torch_fused_slice import (HZ, T, WZ, _assert_bf16_agree, _bf16,
                                    _bf16_as_f32, _config, _fill)
from torch_parity import jax_config, jax_sub_config

jatt = importlib.import_module("open_pandora_tpu.ops.attention")
CONV_FLAGS = ("PANDORA_ENABLE_PCONV", "PANDORA_ENABLE_PCONV2")
# (Pallas kernel function, port wrapper) of each route
ROUTES = {"PANDORA_ENABLE_PCONV": ("_kernel", "conv3x3_nhwc"),
          "PANDORA_ENABLE_PCONV2": ("_fused_kernel", "conv3x3_fused")}


@pytest.fixture(scope="module")
def weights():
    cfg = _config()
    shapes = jax.eval_shape(
        functools.partial(JaxDC(jax_config(cfg)).init_params,
                          height=8 * HZ, width=8 * WZ), jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    params = jtu.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)
    port = build_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          state_dict_from_jax(params, cfg).items()},
                         strict=True)
    u = cfg.unet
    rng = np.random.default_rng(32)
    x = rng.standard_normal((2, T, HZ, WZ, u.in_channels)).astype(np.float32)
    ctx = rng.standard_normal(
        (2, u.text_context_len + T * u.img_tokens_per_frame,
         u.context_dim)).astype(np.float32)
    inputs = (x, np.array([700, 700]), ctx, np.array([3, 3]))
    # the JAX fp32 route with no conv flag: the reference of both tests
    ju = junet.UNetModel(jax_sub_config(u), dtype=jnp.float32)
    jax32 = _jax_eval(ju, params["unet"], inputs, _bf16_as_f32)
    return cfg, params, port, inputs, jax32


def _jax_eval(ju, params, inputs, cast):
    x, steps, ctx, fs = inputs
    return jax.jit(ju.apply)(jtu.tree_map(cast, params), cast(x),
                             jnp.asarray(steps, jnp.int32), cast(ctx),
                             fs=jnp.asarray(fs, jnp.int32))


@pytest.fixture
def conv_route(monkeypatch):
    """Both packages' fused routes, and the conv-kernel calls each makes:
    the conv Pallas calls by kernel function on the JAX side (`_on_tpu`
    patched so its conv gates see a TPU; the attention dispatcher then
    takes its Pallas kernels too, the same functions), the conv wrappers on
    the port side (which run their plain versions on a CPU tensor)."""
    for name in CONV_FLAGS:
        monkeypatch.delenv(name, raising=False)
    counts = {}
    real_call = jfn.pl.pallas_call    # one `pl` module serves every kernel

    def call(kernel, *a, **kw):
        fn = getattr(kernel, "func", kernel)
        if fn.__module__ == jc2.__name__:
            counts[fn.__name__] = counts.get(fn.__name__, 0) + 1
        return real_call(kernel, *a, interpret=True, **kw)
    monkeypatch.setattr(jfn.pl, "pallas_call", call)
    monkeypatch.setattr(junet, "_fused_available", lambda: True)
    monkeypatch.setattr(jfn, "_fused_gn_available", lambda: True)
    monkeypatch.setattr(jatt, "_on_tpu", lambda: True)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    for name in ("conv3x3_nhwc", "conv3x3_fused"):
        real = getattr(tlayers, name)

        def spy(*a, _real=real, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(tlayers, name, spy)
    return counts


@pytest.mark.parametrize("flag", CONV_FLAGS)
def test_unet_eval_conv_route_matches_jax(weights, conv_route, monkeypatch,
                                          flag):
    cfg, params, port, inputs, jax32 = weights
    monkeypatch.setenv(flag, "1")   # read by both packages
    jax16 = _jax_eval(junet.UNetModel(jax_sub_config(cfg.unet),
                                      dtype=jnp.bfloat16),
                      params["unet"], inputs, _bf16)
    pallas_fn, wrapper = ROUTES[flag]
    jax_calls = conv_route.pop(pallas_fn, 0)
    assert flags.snapshot() == {flag: True}
    x, steps, ctx, fs = inputs
    with torch.no_grad():
        out = port.model.diffusion_model.to(torch.bfloat16)(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(steps),
            torch.from_numpy(ctx).bfloat16(), fs=torch.from_numpy(fs))
    # the 16x32 level's sites: the input conv, the two convs of the
    # encoder's level-0 ResBlock and of each of the decoder's two, and the
    # Upsample conv; the 8x16 level (128 pixels) is refused on both sides
    assert jax_calls == conv_route.pop(wrapper) == 8
    assert conv_route == {}, conv_route      # no other conv kernel ran
    assert out.dtype == torch.bfloat16 and out.shape == (2, T, HZ, WZ, 4)
    _assert_bf16_agree(out, jax16, jax32)
