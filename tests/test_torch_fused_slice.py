"""PyTorch port, the slice on the fused route: one batched-CFG UNet eval
and one VAE decode of a tiny bf16 config whose top level has 512 tokens, on
the port's fused route (plain versions of the GroupNorm+SiLU, packed and
fused temporal kernels on the CPU) against the JAX package's default route
(its three Pallas kernels in interpreter mode). Weights are a seeded params
tree of the JAX model's shape, loaded into the port through
`state_dict_from_jax` with a strict load."""

import dataclasses
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

import open_pandora_tpu.models.unet3d as junet
import open_pandora_tpu.models.vae as jvae
import open_pandora_tpu.ops.fused_norms as jfn
import open_pandora_tpu.ops.fused_temporal as jft
import open_pandora_tpu.ops.packed_attention as jpa
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu_torch.core.convert import state_dict_from_jax
from open_pandora_tpu_torch.eval.inference import build_model, debug_config
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import kernels
from torch_parity import jax_config, jax_sub_config, max_abs

T, HZ, WZ = 4, 16, 32     # latent 16x32: 512 tokens at the top level
tft = importlib.import_module("open_pandora_tpu_torch.ops.fused_temporal")
tpa = importlib.import_module("open_pandora_tpu_torch.ops.packed_attention")


def _config():
    """The --debug config (64 channels, 2 levels, head width 32, 7 text and
    2 image tokens per frame) with attention at both levels and a learnable
    image-stream gate, so the dual kernel's gate is not 1."""
    cfg = debug_config(T)
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, attention_resolutions=(1, 2),
        image_cross_attention_scale_learnable=True))


def _fill(path, s, rng):
    """Seeded values at realistic scales: kernels N(0, 1/fan_in), norm
    scales 1 +- 0.05, the image gates' alpha 0 +- 0.5 (gates tanh(alpha) + 1
    well away from 1), everything else 0 +- 0.05."""
    if len(s.shape) >= 2:
        fan_in = math.prod(s.shape[:-1])
        return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(
            np.float32)
    key = jtu.keystr(path)
    base = 1.0 if key.endswith("['scale']") else 0.0
    spread = 0.5 if key.endswith("['alpha']") else 0.05
    return (base + spread * rng.standard_normal(s.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    cfg = _config()
    shapes = jax.eval_shape(
        functools.partial(JaxDC(jax_config(cfg)).init_params,
                          height=8 * HZ, width=8 * WZ), jax.random.PRNGKey(0))
    rng = np.random.default_rng(21)
    params = jtu.tree_map_with_path(lambda p, s: _fill(p, s, rng), shapes)
    port = build_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          state_dict_from_jax(params, cfg).items()},
                         strict=True)
    return cfg, params, port


@pytest.fixture
def fused_route(monkeypatch):
    """Both packages on their fused route, and a count of the kernel calls
    each makes (the Pallas calls in interpreter mode on the JAX side; the
    kernel wrappers, which run their plain versions on a CPU tensor, on the
    port side)."""
    counts = {}
    real_call = jfn.pl.pallas_call    # one `pl` module serves all three

    def call(kernel, *a, **kw):
        mod = getattr(kernel, "func", kernel).__module__
        counts[mod] = counts.get(mod, 0) + 1
        return real_call(kernel, *a, interpret=True, **kw)
    monkeypatch.setattr(jfn.pl, "pallas_call", call)
    monkeypatch.setattr(junet, "_fused_available", lambda: True)
    monkeypatch.setattr(jfn, "_fused_gn_available", lambda: True)
    monkeypatch.setattr(kernels, "fused_available", lambda x: True)
    for mod, name in ((tpa, "packed_attention"),
                      (tft, "fused_temporal_self_attention")):
        real = getattr(mod, name)

        def spy(*a, _real=real, _name=name, **kw):
            counts[_name] = counts.get(_name, 0) + 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(tunet, "fused_temporal_self_attention",
                        getattr(tft, "fused_temporal_self_attention"))
    return counts


def _bf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _bf16_as_f32(a):
    """a rounded to bf16 and held in fp32: the fp32 reference sees the
    weights and inputs the bf16 routes see."""
    return _bf16(a).astype(jnp.float32)


def _assert_bf16_agree(port16, jax16, jax32):
    """The port's bf16 fused route against the JAX package's bf16 fused
    route (jax16) and its fp32 route (jax32), all on the same bf16-rounded
    weights and inputs. The limit is taken from the JAX side alone: twice
    what the JAX bf16 route differs from its fp32 route, plus 1% of mean
    |jax32| (the JAX package's fused_selfcheck rule). The port's bf16 route
    must be within it of the fp32 route and of the JAX bf16 route; the two
    bf16 routes round in different places (GN's E[x^2] - mu^2 against
    two-pass statistics, convolution and GEMM accumulation order), so the
    port's is held to the JAX route's own distance from fp32, not to a
    last-bit match. Reading on the UNet eval: 0.044 from fp32 and 0.0625
    from the JAX bf16 route, limit 0.092 (outputs of mean |value| 0.41);
    on the decode 0.024 and 0.031, limit 0.054. A fused route that drops
    the image gate, the image stream, the GroupNorm bias or SiLU, the
    temporal out-projection bias, the LN shift or the score scale lands
    at 0.18 to 3.0 and fails."""
    port16 = port16.float().numpy()
    jax16, jax32 = (np.asarray(a.astype(jnp.float32)) for a in (jax16, jax32))
    limit = 2 * max_abs(jax16, jax32) + 1e-2 * np.abs(jax32).mean()
    assert max_abs(port16, jax32) <= limit
    assert max_abs(port16, jax16) <= limit


def test_unet_eval_fused_route_matches_jax(weights, fused_route):
    cfg, params, port = weights
    u = cfg.unet
    rng = np.random.default_rng(22)
    x = rng.standard_normal((2, T, HZ, WZ, u.in_channels)).astype(np.float32)
    ctx = rng.standard_normal(
        (2, u.text_context_len + T * u.img_tokens_per_frame,
         u.context_dim)).astype(np.float32)
    steps, fs = np.array([700, 700]), np.array([3, 3])
    ref = {}
    for dt, cast in ((jnp.bfloat16, _bf16), (jnp.float32, _bf16_as_f32)):
        # jit, as the JAX package serves it (and half the eager CPU time)
        ju = junet.UNetModel(jax_sub_config(u), dtype=dt)
        ref[dt] = jax.jit(ju.apply)(
            jtu.tree_map(cast, params["unet"]), cast(x),
            jnp.asarray(steps, jnp.int32), cast(ctx),
            fs=jnp.asarray(fs, jnp.int32))
    unet = port.model.diffusion_model
    with torch.no_grad():
        out = unet.to(torch.bfloat16)(
            torch.from_numpy(x).bfloat16(), torch.from_numpy(steps),
            torch.from_numpy(ctx).bfloat16(), fs=torch.from_numpy(fs))
    # every kernel of the route ran on both sides: GroupNorm per norm site,
    # packed attention for attn1 and attn2 of the three 512-token spatial
    # transformers, fused temporal for attn1 and attn2 of init_attn and the
    # seven temporal transformers
    assert fused_route[jfn.__name__] > 0
    assert fused_route[jpa.__name__] == fused_route["packed_attention"] == 6
    assert fused_route[jft.__name__] == \
        fused_route["fused_temporal_self_attention"] == 16
    assert out.dtype == torch.bfloat16 and out.shape == (2, T, HZ, WZ, 4)
    _assert_bf16_agree(out, ref[jnp.bfloat16], ref[jnp.float32])


def test_vae_decode_fused_route_matches_jax(weights, fused_route):
    cfg, params, port = weights
    z = np.random.default_rng(23).standard_normal(
        (1, 2, HZ, WZ, cfg.vae.z_channels)).astype(np.float32)
    ref = {}
    for dt, cast in ((jnp.bfloat16, _bf16), (jnp.float32, _bf16_as_f32)):
        jmodel = jvae.AutoencoderKL(jax_sub_config(cfg.vae), dtype=dt)
        ref[dt] = jvae.decode_video(jmodel, jtu.tree_map(cast, params["vae"]),
                                    cast(z), frame_chunk=2)
    with torch.no_grad():
        out = port.to(torch.bfloat16).decode(torch.from_numpy(z),
                                             frame_chunk=2)
    assert fused_route[jfn.__name__] > 0
    assert out.dtype == torch.bfloat16 and out.shape == (1, 2, 32, 64, 3)
    _assert_bf16_agree(out, ref[jnp.bfloat16], ref[jnp.float32])
