"""PyTorch port, one `dynamicrafter` finetune step against the JAX package
(tiny config, fp32, CPU): the same weights (NumPy seed, through the JAX
package's converter), the same batch, and the draws JAX's step makes from
its key (posterior noise, CFG dropout mask, timesteps, diffusion noise)
injected into the port. Dropout is off on both sides (the config's rate is
0; the temporal conv blocks' hard-coded 0.1 is set to 0 too). Compared:
the loss, the gradient norm, every UNet gradient and the parameters after
the clipped AdamW update. Then the port alone: gradient checkpointing on
and off give the same gradients with dropout on, under one seed."""

import dataclasses
import functools

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pandora_tpu.core.config import TrainConfig as JaxTrainConfig
from open_pandora_tpu.core.convert import convert_dynamicrafter
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu.train.optim import make_optimizer, trainable_partition
from open_pandora_tpu.train.step import _finetune_loss
from open_pandora_tpu_torch.core import convert as tconvert
from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.eval.inference import build_model, debug_config
from open_pandora_tpu_torch.train.step import TrainState, make_finetune_step
from torch_parity import (jax_config, jax_finetune_draws, max_abs,
                          rerandomize_)

B, HW = 2, 32
TRAIN = dict(learning_rate=1e-4, uncond_prob=0.5, grad_clip_norm=0.5)
UNET = "model.diffusion_model"


def _batch(cfg):
    rng = np.random.default_rng(21)
    t = cfg.unet.temporal_length
    return {
        "video": rng.uniform(-1, 1, (B, t, HW, HW, 3)).astype(np.float32),
        "cond_frames": rng.uniform(-1, 1, (B, 1, HW, HW, 3)).astype(
            np.float32),
        "cond_images": rng.random((B, 40, 48, 3), np.float32),
        "text_tokens": rng.integers(1, 49000, (B, 7)).astype(np.int32),
        "fps": np.asarray([8, 3], np.int32),
    }


def _jax_draws(key, cfg, tcfg, latent_shape):
    """The draws `_finetune_loss` and `diffusion_loss` make from `key`
    (train/step.py:65, diffusion/losses.py:46-52)."""
    return jax_finetune_draws(key, tcfg.uncond_prob, cfg.diffusion.timesteps,
                              B, latent_shape)


def _no_dropout(rate, deterministic=None, **kw):
    return _FlaxDropout(0.0, deterministic=deterministic, **kw)


_FlaxDropout = flax.linen.Dropout


@pytest.fixture(scope="module")
def reference():
    cfg = debug_config()
    port = build_model(cfg, device="cpu")
    flat = rerandomize_(port, seed=11)
    jc = jax_config(cfg)
    jmodel = JaxDC(jc)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert_dynamicrafter(flat, jc))
    jtcfg = JaxTrainConfig(**TRAIN)
    batch = _batch(cfg)
    t = cfg.unet.temporal_length
    latent = (B, t, HW // 2, HW // 2, cfg.vae.z_channels)
    # a key whose CFG dropout mask keeps one sample's text and drops the
    # other's, so both branches of the swap are compared
    key = next(k for k in map(jax.random.PRNGKey, range(20))
               if _jax_draws(k, cfg, jtcfg, latent)["uncond"].sum() == 1)
    trainable, frozen = trainable_partition(jparams, "dynamicrafter")
    with pytest.MonkeyPatch.context() as mp:
        # the temporal conv blocks' hard-coded dropout 0.1 off
        mp.setattr(flax.linen, "Dropout", _no_dropout)
        loss_and_grad = jax.jit(jax.value_and_grad(
            functools.partial(_finetune_loss, jmodel, jtcfg), has_aux=True))
        (loss, metrics), grads = loss_and_grad(
            trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
            key)
    # the rest of make_finetune_step's step (train/step.py:354-356)
    tx = make_optimizer(jtcfg)
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)
    ref = {
        "loss": float(loss), "loss_simple": float(metrics["loss_simple"]),
        "grad_norm": float(optax.global_norm(grads)),
        "grads": _unet_flat(grads["unet"], cfg),
        "new": _unet_flat(new["unet"], cfg),
        "old": _unet_flat(trainable["unet"], cfg),
    }
    return cfg, flat, batch, _jax_draws(key, cfg, jtcfg, latent), ref


def _unet_flat(tree, cfg):
    """A JAX UNet tree (params, grads) under the port's state-dict names."""
    out = {}
    tconvert.unet(out, jax.tree_util.tree_map(np.asarray, tree), cfg.unet,
                  UNET)
    return out


def _port_state(cfg, flat, tcfg):
    port = build_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in flat.items()})
    for m in port.modules():    # the temporal conv blocks' 0.1 as well
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return TrainState.create(port, "dynamicrafter", tcfg)


def test_finetune_step_matches_jax(reference):
    cfg, flat, batch, draws, ref = reference
    tcfg = TrainConfig(**TRAIN)
    state = _port_state(cfg, flat, tcfg)
    step = make_finetune_step(state.model, tcfg)
    m = step(state, batch,
             draws={k: torch.from_numpy(v) for k, v in draws.items()})
    assert state.step == 1
    # fp32 on both sides; the loss and norm differ in summation order only
    assert abs(float(m["loss"]) - ref["loss"]) < 1e-5 * ref["loss"]
    assert abs(float(m["loss_simple"]) - ref["loss_simple"]) < \
        1e-5 * ref["loss"]
    assert abs(float(m["grad_norm"]) - ref["grad_norm"]) < \
        1e-4 * ref["grad_norm"]
    assert ref["grad_norm"] > tcfg.grad_clip_norm   # the clip is exercised
    # the port's .grad are clipped in place: JAX's grads times the clip
    coef = tcfg.grad_clip_norm / ref["grad_norm"]
    grads = {k: p.grad for k, p in state.trainable.items()}
    assert grads.keys() == ref["grads"].keys()
    worst = max(max_abs(grads[k], ref["grads"][k] * coef)
                / max(float(np.abs(ref["grads"][k]).max()) * coef, 1e-3)
                for k in grads)
    # every UNet gradient within 1e-3 of its own largest entry (fp32
    # summation order through about 100 layers; measured below 1e-4)
    assert worst < 1e-3, worst
    # AdamW's first step moves each parameter by lr g / (|g| + eps), about
    # lr sign(g): held to 1% of lr where |g| > 100 eps. Below that the
    # step turns on relative gradient differences the check above allows
    # (a gradient of 2e-9 against 1.8e-9 moves 0.167 lr against 0.153 lr),
    # so there the two may differ by up to a flipped sign, 2 lr
    # (test_torch_train_ops.py holds the optimizer itself to optax exactly).
    lr, eps = tcfg.learning_rate, tcfg.adam_eps
    for k, p in state.trainable.items():
        gap = np.abs(p.detach().numpy() - ref["new"][k])
        big = np.abs(ref["grads"][k] * coef) > 100 * eps
        assert gap[big].max(initial=0.0) < 1e-2 * lr, k
        assert gap.max() <= 2 * lr * (1 + 1e-3), k
        assert max_abs(p.detach(), ref["old"][k]) > 0.5 * lr, k
    # the frozen sub-models did not move
    for k, p in state.model.named_parameters():
        if not k.startswith(UNET):
            assert np.array_equal(p.detach().numpy(), flat[k]), k


def test_checkpointing_keeps_gradients(reference):
    """torch.utils.checkpoint recomputes each block with the RNG state of
    its forward, so with dropout 0.1 the masks, and so the gradients, are
    those of the run without checkpointing under the same seed."""
    cfg, flat, batch, draws, _ = reference
    tcfg = TrainConfig(**TRAIN)
    grads = {}
    for remat, seed in ((True, 5), (False, 5), (True, 6)):
        c = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, dropout=0.1, use_checkpoint=remat))
        port = build_model(c, device="cpu")
        port.load_state_dict({k: torch.from_numpy(v)
                              for k, v in flat.items()})
        state = TrainState.create(port, "dynamicrafter", tcfg)
        torch.manual_seed(seed)
        make_finetune_step(port, tcfg)(
            state, batch,
            draws={k: torch.from_numpy(v) for k, v in draws.items()})
        grads[remat, seed] = {k: p.grad.clone()
                              for k, p in state.trainable.items()}

    def gap(a, b):   # the largest difference, relative to each tensor
        return max(max_abs(a[k], b[k]) / max(float(b[k].abs().max()), 1e-3)
                   for k in a)
    # the same masks: equal up to the order autograd sums shared inputs
    assert gap(grads[True, 5], grads[False, 5]) < 1e-5
    # other masks: far apart, so the check above can see a redrawn mask
    assert gap(grads[True, 6], grads[False, 5]) > 1e-2
