"""PyTorch port, modules: norms, schedules and DDIM params, the timestep
embedding, CLIP preprocessing, and the tiny VAE, OpenCLIP text and vision
towers, Resampler and UNet3D against the JAX package on the CPU in fp32.
Every parameter is re-randomised from a NumPy seed (zero-initialised layers
included), loaded into the port, and converted for JAX by the JAX package's
own converters."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import convert as jconv
from open_pandora_tpu.diffusion import ddim as jddim
from open_pandora_tpu.diffusion import schedule as jsched
from open_pandora_tpu.models import encoders as jenc
from open_pandora_tpu.models import unet3d as junet
from open_pandora_tpu.models import vae as jvae
from open_pandora_tpu.ops import norms as jnorms
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.diffusion import ddim as tddim
from open_pandora_tpu_torch.diffusion import schedule as tsched
from open_pandora_tpu_torch.models import encoders as tenc
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.models import vae as tvae
from open_pandora_tpu_torch.ops import norms as tnorms
from torch_parity import (jax_sub_config, max_abs, prefixed, rerandomize_,
                          to_jax)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- norms, schedules, embeddings ---------------------------------------------


@pytest.mark.parametrize("shape,eps,silu", [
    ((2, 4, 4, 64), 1e-5, True),         # ResBlock GN+SiLU
    ((2, 3, 4, 4, 64), 1e-6, False),     # transformer GN over (t, h, w)
    ((1, 8, 8, 96), 1e-6, True),         # VAE
])
def test_group_norm(shape, eps, silu):
    x, w, b = _rand(0, *shape), _rand(1, shape[-1]), _rand(2, shape[-1])
    out = tnorms.group_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), eps=eps, silu=silu)
    ref = jnorms.group_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            eps=eps, silu=silu)
    assert max_abs(out, ref) < 1e-5  # fp32, reduction order


def test_layer_norm():
    x, w, b = _rand(0, 3, 5, 48), _rand(1, 48), _rand(2, 48)
    out = tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), eps=1e-5)
    ref = jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            eps=1e-5)
    assert max_abs(out, ref) < 1e-5
    xb = torch.from_numpy(x).bfloat16()
    assert tnorms.layer_norm(xb, None, None).dtype == torch.bfloat16


def test_schedule_matches():
    cfg = tcfg.DiffusionConfig()
    ts, js = tsched.make_schedule(cfg), jsched.make_schedule(jax_sub_config(cfg))
    for f in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
              "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
              "scale_arr"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


@pytest.mark.parametrize("spacing", ["uniform", "uniform_trailing", "quad"])
@pytest.mark.parametrize("eta,steps", [(0.0, 10), (1.0, 50), (1.0, 4)])
def test_ddim_params_match(spacing, eta, steps):
    cfg = tcfg.DiffusionConfig()
    tp = tddim.make_ddim_schedule(tsched.make_schedule(cfg), steps, eta,
                                  spacing)
    jp = jddim.make_ddim_schedule(jsched.make_schedule(jax_sub_config(cfg)), steps,
                                  eta, spacing)
    for f in dataclasses.fields(tp):
        np.testing.assert_array_equal(getattr(tp, f.name),
                                      np.asarray(getattr(jp, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("dim", [32, 320, 33])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 15, 24, 999], np.int64)
    np.testing.assert_array_equal(
        tsched.bf16_freq_table(dim // 2).numpy(),
        jsched._bf16_freq_table(dim // 2, 10000))
    out = tsched.timestep_embedding(torch.from_numpy(t), dim)
    ref = jsched.timestep_embedding(jnp.asarray(t, jnp.int32), dim)
    assert out.shape == (5, dim)
    assert max_abs(out, ref) < 1e-4  # cos/sin of args up to ~1000 in fp32


def test_rescale_noise_cfg():
    a, b = _rand(0, 2, 3, 4, 5), _rand(1, 2, 3, 4, 5)
    out = tddim.rescale_noise_cfg(torch.from_numpy(a), torch.from_numpy(b),
                                  0.7)
    ref = jddim.rescale_noise_cfg(jnp.asarray(a), jnp.asarray(b), 0.7)
    assert max_abs(out, ref) < 1e-6


def test_clip_preprocess_real_downscale():
    """320x512 -> 224x224: both sides antialias (triangle filter widened
    by the scale). Tolerance 1e-4 after normalisation: fp32 summation order
    in the filter (~1e-5 on [0, 1] pixels), times 1/std (about 3.8)."""
    img = np.random.default_rng(0).random((2, 320, 512, 3), np.float32)
    out = tenc.clip_preprocess(torch.from_numpy(img))
    ref = jenc.clip_preprocess(jnp.asarray(img))
    assert out.shape == (2, 224, 224, 3)
    assert max_abs(out, ref) < 1e-4
    # without antialiasing the downscale would be far off
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(img).permute(0, 3, 1, 2), size=(224, 224),
        mode="bilinear", align_corners=False).permute(0, 2, 3, 1)
    plain = (plain - torch.tensor(tenc.CLIP_MEAN)) / torch.tensor(
        tenc.CLIP_STD)
    assert max_abs(plain, ref) > 1e-2


# -- tiny modules ---------------------------------------------------------------


def test_vae_encode_decode():
    cfg = tcfg.VAEConfig(base_channels=32, channel_mult=(1, 2),
                         num_res_blocks=1)
    port = tvae.AutoencoderKL(cfg).eval()
    flat = rerandomize_(port, seed=1)
    jparams = to_jax(jconv.convert_vae(prefixed(flat, "first_stage_model"),
                                       jax_sub_config(cfg)))
    jmodel = jvae.AutoencoderKL(jax_sub_config(cfg))
    video = _rand(2, 1, 4, 32, 32, 3)
    with torch.no_grad():
        z = tvae.encode_video(port, torch.from_numpy(video), frame_chunk=2)
        rec = tvae.decode_video(port, z, frame_chunk=2)
    jz = jvae.encode_video(jmodel, jparams, jnp.asarray(video), frame_chunk=2)
    jrec = jvae.decode_video(jmodel, jparams, jz, frame_chunk=2)
    assert z.shape == (1, 4, 16, 16, 4) and rec.shape == video.shape
    assert max_abs(z, jz) < 1e-4      # fp32 through ~10 conv layers
    assert max_abs(rec, jrec) < 1e-4
    with torch.no_grad():
        post = port.encode(torch.from_numpy(video[0]))
    jpost = jmodel.apply(jparams, jnp.asarray(video[0]),
                         method=jvae.AutoencoderKL.encode)
    assert max_abs(post.logvar, jpost.logvar) < 1e-4


def test_clip_text_encoder():
    cfg = tcfg.CLIPTextConfig(width=64, layers=3, heads=2, context_length=7)
    port = tenc.CLIPTextEncoder(cfg).eval()
    flat = rerandomize_(port, seed=2)
    jparams = to_jax(jconv.convert_openclip_text(
        prefixed(flat, "m"), cfg.layers - 1, prefix="m"))
    ids = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    ids[:, 0] = tenc.SOT_TOKEN
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    ref = jenc.CLIPTextEncoder(jax_sub_config(cfg)).apply(jparams,
                                                 jnp.asarray(ids, jnp.int32))
    assert out.shape == (2, 7, 64)
    assert len(port.transformer.resblocks) == 2  # penultimate layer
    assert max_abs(out, ref) < 1e-4


def test_clip_vision_encoder():
    cfg = tcfg.CLIPVisionConfig(image_size=28, patch_size=14, width=64,
                                layers=2, heads=2)
    port = tenc.CLIPVisionEncoder(cfg).eval()
    flat = rerandomize_(port, seed=4)
    jparams = to_jax(jconv.convert_openclip_visual(
        prefixed(flat, "v"), cfg.layers, prefix="v"))
    x = _rand(5, 2, 28, 28, 3)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    ref = jenc.CLIPVisionEncoder(jax_sub_config(cfg)).apply(jparams, jnp.asarray(x))
    assert out.shape == (2, 5, 64)
    assert max_abs(out, ref) < 1e-4


def test_resampler():
    cfg = tcfg.ResamplerConfig(dim=64, depth=2, dim_head=16, heads=2,
                               num_queries=2, embedding_dim=48, output_dim=32,
                               video_length=4)
    port = tenc.Resampler(cfg).eval()
    flat = rerandomize_(port, seed=6)
    jparams = to_jax(jconv.convert_resampler(prefixed(flat, "r"), cfg.depth,
                                             prefix="r"))
    x = _rand(7, 2, 5, 48)
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    ref = jenc.Resampler(jax_sub_config(cfg)).apply(jparams, jnp.asarray(x))
    assert out.shape == (2, 8, 32)
    assert max_abs(out, ref) < 1e-4


def test_unet3d():
    """Two levels with attention at both, init_attn, dual text+image
    cross-attention, fps conditioning and temporal convs."""
    T = 2
    cfg = tcfg.UNet3DConfig(
        in_channels=8, out_channels=4, model_channels=32, channel_mult=(1, 2),
        num_res_blocks=1, attention_resolutions=(1, 2), num_head_channels=16,
        transformer_depth=1, context_dim=32, temporal_length=T, dropout=0.0,
        use_checkpoint=False)
    port = tunet.UNetModel(cfg).eval()
    flat = rerandomize_(port, seed=8)
    jparams = to_jax(jconv.convert_unet(prefixed(flat, "u"), jax_sub_config(cfg),
                                        prefix="u"))
    x = _rand(9, 2, T, 8, 8, 8)
    ctx = _rand(10, 2, 77 + T * 16, 32)
    steps = np.array([999, 500], np.int64)
    fs = np.array([3, 10], np.int64)
    with torch.no_grad():
        out = port(torch.from_numpy(x), torch.from_numpy(steps),
                   torch.from_numpy(ctx), fs=torch.from_numpy(fs))
    ref = junet.UNetModel(jax_sub_config(cfg)).apply(
        jparams, jnp.asarray(x), jnp.asarray(steps, jnp.int32),
        jnp.asarray(ctx), fs=jnp.asarray(fs, jnp.int32))
    assert out.shape == (2, T, 8, 8, 4)
    scale = float(np.abs(np.asarray(ref)).max())
    assert scale > 1e-2  # zero-init layers were re-randomised
    assert max_abs(out, ref) < 1e-4 * max(scale, 1.0)
