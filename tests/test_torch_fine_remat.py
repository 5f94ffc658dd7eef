"""PyTorch port, the two memory switches of the 576x1024 finetune against the
JAX package (CPU, fp32): the GEGLU feed-forward's chunking over the leading
axis (models/unet3d.py FeedForward, JAX :225-271) and PANDORA_FINE_REMAT
(each attention and the feed-forward recomputed on its own inside the
block-level checkpoint, JAX :322-354). Neither may change a value: outputs
and gradients are compared with each switch on and off, and against JAX.
Also the launch counts a 576x1024 training step makes under FINE_REMAT
(meta device, stand-in launchers) against chip_smoke's prediction, and the
trainer's sample grid, which must leave every module's mode as it was."""

import collections
import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from open_pandora_tpu.core import convert as jconv
from open_pandora_tpu.core import flags as jflags
from open_pandora_tpu.models import unet3d as junet
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core import flags as tflags
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import flash_attention as tfa
from open_pandora_tpu_torch.ops import small_attention as tsa
from open_pandora_tpu_torch.ops.attention import attention_route
from open_pandora_tpu_torch.ops.attention_xla import mha
from torch_parity import (jax_sub_config, max_abs, prefixed, rerandomize_,
                          to_jax)


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are tiny: one intra-op thread keeps their ops from
    competing for the cores with the suite's other workers, where eight
    spinning threads each slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- feed-forward chunking ---------------------------------------------------------


@pytest.mark.parametrize("shape,dim,chunks", [
    ((9216, 16, 320), 320, 4),    # level-0 temporal site, 576x1024 training
    ((16, 9216, 320), 320, 4),    # level-0 spatial site, 576x1024 training
    ((32, 9216, 320), 320, 8),    # the CFG eval at 576x1024
    ((2, 16, 9216, 320), 320, 2),  # the native temporal stream of that eval
    ((32, 2560, 320), 320, 1),    # 320x512: under the threshold
    ((9215, 16, 320), 320, 1),    # an odd leading axis is not chunked
])
def test_chunk_counts_at_full_width(shape, dim, chunks):
    """The port's rule at the real thresholds (256M and 128M elements of
    the intermediate) on the 576x1024 sites; computed from the shape."""
    assert tunet.FeedForward.CHUNK_THRESHOLD == junet.FeedForward.CHUNK_THRESHOLD
    assert tunet.FeedForward.CHUNK_TARGET == junet.FeedForward.CHUNK_TARGET
    with torch.device("meta"):
        ff = tunet.FeedForward(dim)
    assert ff.chunks(shape) == chunks


def _jax_ff_params(ff: tunet.FeedForward) -> dict:
    def dense(lin):
        return {"kernel": jnp.asarray(lin.weight.detach().numpy().T),
                "bias": jnp.asarray(lin.bias.detach().numpy())}
    return {"params": {"net_0_proj": dense(ff.net[0].proj),
                       "net_2": dense(ff.net[2])}}


@pytest.mark.parametrize("shape,chunks", [
    ((16, 5, 32), 16), ((6, 5, 32), 2), ((5, 7, 32), 1), ((2, 3, 4, 32), 2),
    ((3, 2, 32), 1)])
def test_chunked_ff_matches_jax(monkeypatch, shape, chunks):
    """Both packages' thresholds lowered to 4096 and 2048 elements so that
    small inputs chunk: the port's chunked output against JAX's (fp32,
    within 1e-5 of the output's scale) and against its own unchunked output
    (the same products on row slices: within 1e-6)."""
    for cls in (tunet.FeedForward, junet.FeedForward):
        monkeypatch.setattr(cls, "CHUNK_THRESHOLD", 4096)
        monkeypatch.setattr(cls, "CHUNK_TARGET", 2048)
    ff = tunet.FeedForward(shape[-1])
    rerandomize_(ff, seed=31)
    assert ff.chunks(shape) == chunks
    x = _rand(32, *shape)
    with torch.no_grad():
        out = ff(torch.from_numpy(x))
        whole = ff._ff(torch.from_numpy(x))
    ref = junet.FeedForward().apply(_jax_ff_params(ff), jnp.asarray(x))
    scale = float(np.abs(np.asarray(ref)).max())
    assert max_abs(out, ref) < 1e-5 * scale
    assert max_abs(out, whole) < 1e-6 * scale


# -- FINE_REMAT: a training forward and backward of a small UNet ---------------------

CFG = tcfg.UNet3DConfig(
    in_channels=8, out_channels=4, model_channels=32, channel_mult=(1,),
    num_res_blocks=1, attention_resolutions=(1,), num_head_channels=16,
    transformer_depth=1, context_dim=32, temporal_length=2, dropout=0.0,
    use_checkpoint=True)


def _no_dropout(rate, deterministic=None, **kw):
    return _FlaxDropout(0.0, deterministic=deterministic, **kw)


_FlaxDropout = flax.linen.Dropout


@pytest.fixture(scope="module")
def unet_case():
    """A one-level UNet (spatial and temporal transformers, init_attn,
    dual text + image cross-attention, temporal convs) with seeded
    weights, inputs and a seeded cotangent: the loss is sum(out * w)."""
    port = tunet.UNetModel(CFG)
    flat = rerandomize_(port, seed=33)
    t = CFG.temporal_length
    inputs = {"x": _rand(34, 2, t, 8, 8, 8),
              "ctx": _rand(35, 2, 77 + t * 16, 32),
              "steps": np.array([999, 500], np.int64),
              "fs": np.array([3, 10], np.int64),
              "w": _rand(36, 2, t, 8, 8, 4)}
    return flat, inputs


def _port_grads(flat, inputs, fine: bool):
    port = tunet.UNetModel(CFG)
    port.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    for m in port.modules():    # the temporal conv blocks' 0.1 as well
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    port.train()
    x = torch.from_numpy(inputs["x"]).requires_grad_()
    with tflags.overridden(FINE_REMAT=fine):
        out = port(x, torch.from_numpy(inputs["steps"]),
                   torch.from_numpy(inputs["ctx"]),
                   fs=torch.from_numpy(inputs["fs"]))
        terms = out * torch.from_numpy(inputs["w"])
        terms.sum().backward()
    grads = {k: p.grad.numpy().copy() for k, p in port.named_parameters()}
    grads["x"] = x.grad.numpy().copy()
    return float(terms.sum()), float(terms.abs().sum()), grads


def test_fine_remat_changes_no_gradient(unet_case):
    """With FINE_REMAT the port's loss and every gradient (parameters and
    input) equal those without it, up to the order autograd sums shared
    inputs (1e-6 of each tensor's largest entry)."""
    flat, inputs = unet_case
    loss0, scale, g0 = _port_grads(flat, inputs, False)
    loss1, _, g1 = _port_grads(flat, inputs, True)
    assert abs(loss1 - loss0) <= 1e-6 * scale
    assert g0.keys() == g1.keys()
    for k in g0:
        assert max_abs(g1[k], g0[k]) <= 1e-6 * max(
            float(np.abs(g0[k]).max()), 1e-3), k


def test_fine_remat_matches_jax(unet_case):
    """The port's FINE_REMAT training forward and backward against the JAX
    package's under its FINE_REMAT (nn.remat per attention and per
    feed-forward inside the block remat), dropout off on both sides: the
    loss within 1e-5 of sum |out * w| (a sum of terms of both signs),
    every gradient within 1e-4 of its own largest entry (fp32 summation
    order through the UNet), or of 1e-3 of the largest entry of any
    gradient where its own is smaller: some gradients are sums that cancel
    to their rounding (the bias of a conv before a GroupNorm of one channel
    a group is 0 in exact arithmetic; the time embedding's are about
    1e-7)."""
    flat, inputs = unet_case
    loss, scale, grads = _port_grads(flat, inputs, True)
    jparams = to_jax(jconv.convert_unet(prefixed(flat, "u"),
                                        jax_sub_config(CFG), prefix="u"))
    jmodel = junet.UNetModel(jax_sub_config(CFG))

    def jloss(params, x):
        out = jmodel.apply(params, x, jnp.asarray(inputs["steps"], jnp.int32),
                           jnp.asarray(inputs["ctx"]),
                           fs=jnp.asarray(inputs["fs"], jnp.int32),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return (out * jnp.asarray(inputs["w"])).sum()

    with pytest.MonkeyPatch.context() as mp, \
            jflags.overridden(FINE_REMAT=True):
        mp.setattr(flax.linen, "Dropout", _no_dropout)
        ref, (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
            jparams, jnp.asarray(inputs["x"]))
    assert abs(loss - float(ref)) <= 1e-5 * scale
    from open_pandora_tpu_torch.core import convert as tconvert
    ref_grads = {}
    tconvert.unet(ref_grads, jax.tree_util.tree_map(np.asarray, jg),
                  CFG, "u")
    ref_grads = {k[2:]: v for k, v in ref_grads.items()}
    ref_grads["x"] = np.asarray(jgx)
    assert ref_grads.keys() == grads.keys()
    top = max(float(np.abs(g).max()) for g in ref_grads.values())
    for k, g in grads.items():
        assert max_abs(g, ref_grads[k]) <= 1e-4 * max(
            float(np.abs(ref_grads[k]).max()), 1e-3 * top), k


# -- FINE_REMAT: launch counts of a 576x1024 training step --------------------------


def test_fine_remat_train_step_launches_as_predicted(monkeypatch):
    """PandoraConfig()'s UNet at 576x1024, batch 1, bf16, training, on the
    meta device with counting stand-ins for the attention kernels: under
    FINE_REMAT each attention runs forward three times (the forward, the
    block's recompute, its own recompute inside it) and backward once:
    45 flash, 102 small, 15 flash-backward and 34 small-backward launches,
    chip_smoke's prediction for phase 10 without the VAE's share."""
    calls = collections.Counter()

    def fwd(name, with_lse):
        def launch(q, k, v, **kw):
            calls[name] += 1
            o = torch.empty_like(q)
            if with_lse:
                return o, torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                      device=q.device)
            return o
        return launch

    def bwd(name):
        def launch(q, k, v, *rest, **kw):
            calls[name] += 1
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v))
        return launch

    def attention(q, k, v, causal=False, mask=None, sm_scale=None):
        route = attention_route(q.shape, k.shape, causal=causal,
                                masked=mask is not None, on_device=True)
        if route == "flash":
            return tfa.flash_attention(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
        if route == "small":
            return tsa.small_attention(q, k, v, sm_scale=sm_scale)
        return mha(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)

    monkeypatch.setattr(tfa, "_flash_cuda", fwd("flash", True))
    monkeypatch.setattr(tfa, "_flash_bwd_cuda", bwd("flash_bwd"))
    monkeypatch.setattr(tsa, "_small_cuda", fwd("small", False))
    monkeypatch.setattr(tsa, "_small_bwd_cuda", bwd("small_bwd"))
    monkeypatch.setattr(tunet, "attention", attention)
    cfg = tcfg.PandoraConfig()
    u = cfg.unet
    with torch.device("meta"):
        model = tunet.UNetModel(u).to(torch.bfloat16)
    model.train()
    t, hz, wz = u.temporal_length, 72, 128
    x = torch.empty(1, t, hz, wz, u.in_channels, dtype=torch.bfloat16,
                    device="meta")
    ctx = torch.empty(1, u.text_context_len + t * u.img_tokens_per_frame,
                      u.context_dim, dtype=torch.bfloat16, device="meta")
    with tflags.overridden(FINE_REMAT=True):
        out = model(x, torch.zeros(1, dtype=torch.int64, device="meta"), ctx)
        out.float().sum().backward()
    want = chip_smoke.predicted_train_launches(
        cfg, 576, 1024, batch=1, frames=17, bf16=True, fine_remat=True)
    vae = chip_smoke.predicted_launches(cfg, 576, 1024, 1, frame_chunk=1,
                                        fused=True)["encode"]
    assert dict(calls) == {"flash": 45, "small": 102, "flash_bwd": 15,
                           "small_bwd": 34}
    assert {k: want[k] - 17 * vae[k] for k in calls} == dict(calls)
    plain = chip_smoke.predicted_train_launches(cfg, 576, 1024, batch=1,
                                                frames=17, bf16=True)
    assert (plain["flash"] - 17 * vae["flash"], plain["small"]) == (30, 68)


# -- the trainer's sample grid -------------------------------------------------------


def test_sample_grid_restores_modes(tmp_path):
    """train.trainer.sample_grid on the tiny WorldModel as the finetune
    stage leaves it (UNet and connector training, the rest in eval): the
    sample runs with every module in eval mode (the route JAX's
    deterministic call takes), writes a (h, 4 w) grid of the tiny clip's
    4 frames, and leaves every module's mode as it found it."""
    from PIL import Image

    from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                         debug_world_config)
    from open_pandora_tpu_torch.train import trainer
    from open_pandora_tpu_torch.train.optim import trainable_partition

    cfg = debug_world_config()
    wm = build_world_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    trainable_partition(wm, "finetune")
    before = [m.training for m in wm.modules()]
    assert any(before) and not all(before)
    seen = []
    real = wm.diffusion.apply_model

    def spy(*a, **kw):
        seen.append(any(m.training for m in wm.modules()))
        return real(*a, **kw)
    wm.diffusion.apply_model = spy
    rng = np.random.default_rng(37)
    batch = {"cond_images": rng.random((2, 40, 48, 3), np.float32),
             "cond_frames": rng.uniform(-1, 1, (2, 1, 32, 32, 3)).astype(
                 np.float32)}
    path = trainer.sample_grid(wm, batch, cfg, str(tmp_path / "s.png"))
    assert seen and not any(seen)
    assert [m.training for m in wm.modules()] == before
    with Image.open(path) as im:
        assert im.size == (4 * 32, 32) and im.mode == "RGB"
