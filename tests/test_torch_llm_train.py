"""PyTorch port, the LLM-conditioned training stages against the JAX
package (tiny config, fp32, CPU): one `alignment` step and one WorldModel
`finetune` step. The weights are a seeded tree of the JAX WorldModel's
init shapes, crossing to the port through `state_dict_from_jax`
(test_torch_world_slice.make_world); the batch is the same; the finetune
step's draws (posterior noise, CFG mask, timesteps, diffusion noise) come
from JAX's key and are injected into the port, and dropout is off on both
sides. The JAX reference is the stage's own loss function, taken from the
step that make_alignment_step / make_wm_finetune_step build, under
jax.value_and_grad, then the clipped AdamW of make_optimizer. Compared:
the loss, the gradient norm, every trainable gradient (the connector's
image_prefix rows, whose gradient crosses the frozen LLaMA, included) and
the parameters after the update."""

import inspect

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pandora_tpu.core.config import TrainConfig as JaxTrainConfig
from open_pandora_tpu.train import step as jstep
from open_pandora_tpu.train.optim import make_optimizer, trainable_partition
from open_pandora_tpu_torch.core import convert as tconvert
from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.train.step import (TrainState,
                                               make_alignment_step,
                                               make_wm_finetune_step)
from test_torch_world_slice import make_world
from torch_parity import jax_finetune_draws, max_abs

B, HW = 2, 32
TRAIN = dict(learning_rate=1e-4, uncond_prob=0.5, grad_clip_norm=0.5)
UNET = "diffusion_model.model.diffusion_model"
# fp32 on both sides: the loss differs in summation order only; every
# gradient within 1e-3 of its own tensor's largest entry
LOSS_REL, GRAD_REL = 1e-4, 1e-3


def _batch(cfg):
    rng = np.random.default_rng(41)
    t, s = cfg.unet.temporal_length, cfg.clip_tower.image_size
    llm = rng.integers(3, 31000, (B, 6)).astype(np.int32)
    llm[:, 0] = 1                                           # bos
    return {
        "video": rng.uniform(-1, 1, (B, t, HW, HW, 3)).astype(np.float32),
        "cond_frames": rng.uniform(-1, 1, (B, 1, HW, HW, 3)).astype(
            np.float32),
        "cond_images": rng.random((B, s, s, 3), np.float32),
        "text_tokens": rng.integers(1, 49000, (B, cfg.clip_text.context_length)
                                    ).astype(np.int32),
        "llm_text_tokens": llm,
        "fps": np.asarray([8, 3], np.int32),
    }


def _stage_loss(make, wm, jtcfg):
    """The loss function inside the step JAX's make_*_step builds."""
    step, _ = make(wm, jtcfg)
    return inspect.getclosurevars(step.raw_step).nonlocals["lfn"]


def _no_dropout(rate, deterministic=None, **kw):
    return _FlaxDropout(0.0, deterministic=deterministic, **kw)


_FlaxDropout = flax.linen.Dropout


def _port_names(tree, cfg):
    """A JAX trainable tree (params, grads) under the port's parameter
    names: the UNet's state-dict keys, the connector's under `connector.`
    (the WorldModel's state dict lifts them to the top level)."""
    out, conn = {}, {}
    tree = jax.tree_util.tree_map(np.asarray, tree)
    if "unet" in tree:
        tconvert.unet(out, tree["unet"], cfg.unet, UNET)
    tconvert.connector(conn, tree["connector"])
    out.update({f"connector.{k}": v for k, v in conn.items()})
    return out


def _reference(make, stage, key_pick=None):
    cfg, jwm, params, port = make_world(seed=43)
    jtcfg = JaxTrainConfig(**TRAIN)
    batch = _batch(cfg)
    t = cfg.unet.temporal_length
    latent = (B, t, HW // 2, HW // 2, cfg.vae.z_channels)

    def draws(k):
        return jax_finetune_draws(k, jtcfg.uncond_prob,
                                  cfg.diffusion.timesteps, B, latent)
    key = jax.random.PRNGKey(0)
    if key_pick is not None:
        key = next(k for k in map(jax.random.PRNGKey, range(20))
                   if key_pick(draws(k)))
    trainable, frozen = trainable_partition(params, stage)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _no_dropout)
        lfn = _stage_loss(make, jwm, jtcfg)
        (loss, _), grads = jax.jit(jax.value_and_grad(lfn, has_aux=True))(
            trainable, frozen, {k: jnp.asarray(v) for k, v in batch.items()},
            key)
    tx = make_optimizer(jtcfg)
    updates, _ = tx.update(grads, tx.init(trainable), trainable)
    new = optax.apply_updates(trainable, updates)
    ref = {"loss": float(loss), "grad_norm": float(optax.global_norm(grads)),
           "grads": _port_names(grads, cfg), "new": _port_names(new, cfg)}
    return cfg, port, batch, draws(key), ref


def _check_step(state, m, ref, tcfg):
    assert state.step == 1
    assert abs(float(m["loss"]) - ref["loss"]) < LOSS_REL * abs(ref["loss"])
    assert abs(float(m["grad_norm"]) - ref["grad_norm"]) < \
        LOSS_REL * ref["grad_norm"]
    assert ref["grad_norm"] > tcfg.grad_clip_norm   # the clip is exercised
    coef = tcfg.grad_clip_norm / ref["grad_norm"]
    grads = {k: p.grad for k, p in state.trainable.items()}
    assert grads.keys() == ref["grads"].keys()
    for k, g in grads.items():
        want = ref["grads"][k] * coef
        scale = max(float(np.abs(want).max()), 1e-3 * coef)
        assert max_abs(g, want) <= GRAD_REL * scale, k
    # the gradient crossed the frozen LLaMA into the learned prefix rows
    assert float(np.abs(ref["grads"]["connector.image_prefix.weight"])
                 .max()) > 0
    assert float(grads["connector.image_prefix.weight"].abs().max()) > 0
    # AdamW's first step moves each parameter by about lr sign(g): held to
    # 1% of lr where |g| > 100 eps, to a flipped sign (2 lr) below that
    # (test_torch_train_step.py explains the bound)
    lr, eps = tcfg.learning_rate, tcfg.adam_eps
    for k, p in state.trainable.items():
        gap = np.abs(p.detach().numpy() - ref["new"][k])
        big = np.abs(ref["grads"][k] * coef) > 100 * eps
        assert gap[big].max(initial=0.0) < 1e-2 * lr, k
        assert gap.max() <= 2 * lr * (1 + 1e-3), k


def _zero_dropout(model):
    for mod in model.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0


def test_alignment_step_matches_jax():
    cfg, port, batch, _, ref = _reference(jstep.make_alignment_step,
                                          "alignment")
    tcfg = TrainConfig(**TRAIN)
    frozen = {k: p.detach().clone() for k, p in port.named_parameters()
              if not k.startswith("connector.")}
    state = TrainState.create(port, "alignment", tcfg)
    m = make_alignment_step(port, tcfg)(state, batch)
    _check_step(state, m, ref, tcfg)
    for k, p in port.named_parameters():
        if k in frozen:
            assert torch.equal(p, frozen[k]), k


def test_wm_finetune_step_matches_jax():
    # a key whose CFG mask keeps one sample's LLM conditioning and swaps
    # the other's for the empty prompt: both branches are compared
    cfg, port, batch, draws, ref = _reference(
        jstep.make_wm_finetune_step, "finetune",
        key_pick=lambda d: d["uncond"].sum() == 1)
    tcfg = TrainConfig(**TRAIN)
    _zero_dropout(port)
    state = TrainState.create(port, "finetune", tcfg)
    assert {k.split(".")[0] for k in state.trainable} == {"diffusion_model",
                                                          "connector"}
    m = make_wm_finetune_step(port, tcfg)(
        state, batch,
        draws={k: torch.from_numpy(np.array(v)) for k, v in draws.items()})
    assert abs(float(m["loss_simple"]) - ref["loss"]) < \
        LOSS_REL * abs(ref["loss"])
    _check_step(state, m, ref, tcfg)
