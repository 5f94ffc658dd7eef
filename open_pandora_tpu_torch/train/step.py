"""The train steps of the `dynamicrafter`, `finetune` and `alignment`
stages, on one device or over a (data, model) mesh.

Counterpart of `make_finetune_step`, `_finetune_loss`,
`make_wm_finetune_step`, `make_alignment_step` and
`make_latent_finetune_step` in open_pandora_tpu/train/step.py (reference
model.py:926-949 training_step, get_batch_input :828-884,
alignment_forward :886-923): VAE-encoded video
latents sampled from the posterior, text and image conditioning, CFG
dropout of the text context to the empty prompt, the frame-stride
condition from the batch, and the diffusion loss; or the alignment KL;
then the clipped AdamW update and the optional EMA. The `llm_sft` step is
train/llm_step.py's, on the same `make_finetune_step`.

Batch contract (as the JAX package's):
  video            (b, T, H, W, 3) in [-1, 1]
  cond_frames      (b, t_c, H, W, 3) in [-1, 1]  VAE conditioning frames
  cond_images      (b, hc, wc, 3) in [0, 1]      CLIP image for cross-attn
                                                 (and, in the LLM stages,
                                                 the CLIP tower's image)
  text_tokens      (b, L) int                    tokenized caption
  fps              (b,) int
  llm_text_tokens  (b, n) int                    LLaMA ids (bos + caption),
                                                 the LLM stages only

In the LLM stages the connector trains: its learned [IMG_P] rows enter the
LLaMA's input, so the frozen LLaMA trunk runs with autograd on and the
gradient crosses all its layers, as JAX's value_and_grad sends it. The
VAE encode and the OpenCLIP text and image encoders run under no_grad.

The random draws (posterior noise `eps`, CFG dropout mask `uncond`,
timesteps `t`, diffusion `noise`) for the global batch are the caller's
`draws` dict, or finetune_draws' from an explicit torch.Generator. Dropout
inside the UNet draws from the global RNG (see models/unet3d.py).

Over a mesh (JAX train/step.py:330-415) each data rank passes its slice of
the global batch (parallel.mesh.shard_batch, or the loaders' `shard`) and
takes its slice of the global batch's draws, so N ranks reproduce one
device's step on the global batch; the optimizer averages the gradients
over the data axis (DDP) with ZeRO-2 (train/optim.py), and with fsdp=True
the large parameters are stored sharded (parallel.mesh.apply_fsdp). The
step calls `apply_model` and the encoders, not the module's forward, so
the collectives are explicit, after backward, and no
DistributedDataParallel wrapper is used.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.diffusion.losses import diffusion_loss
from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter
from open_pandora_tpu_torch.models.encoders import (CLIP_MEAN, CLIP_STD,
                                                    empty_prompt_tokens)
from open_pandora_tpu_torch.models.vae import encode_video
from open_pandora_tpu_torch.models.world_model import (MultimodalPrompt,
                                                       WorldModel,
                                                       round1_prompt)
from open_pandora_tpu_torch.parallel.mesh import (MeshSpec, apply_fsdp,
                                                  shard_rows)
from open_pandora_tpu_torch.train.ema import EMA
from open_pandora_tpu_torch.train.optim import Optimizer, trainable_partition

@dataclass
class TrainState:
    """The step count, the model (its trainable parameters updated in
    place), the optimizer over them, and the optional EMA shadow."""

    step: int
    model: nn.Module        # a DynamiCrafter, or a WorldModel
    trainable: Dict[str, torch.Tensor]
    optimizer: Optimizer
    ema: Optional[EMA] = None

    @classmethod
    def create(cls, model: nn.Module, stage: str,
               tcfg: TrainConfig) -> "TrainState":
        """`stage` is a key of train.optim.TRAINABLE_KEYS."""
        trainable, _ = trainable_partition(model, stage)
        return cls(step=0, model=model, trainable=trainable,
                   optimizer=Optimizer(trainable, tcfg),
                   ema=EMA(trainable) if tcfg.use_ema else None)


def _finetune_loss(model: DynamiCrafter, tcfg: TrainConfig,
                   batch: Dict[str, torch.Tensor], *,
                   draws: Dict[str, torch.Tensor],
                   text_context: Optional[Callable] = None):
    """The diffusion loss on `draws` (finetune_draws' keys: `uncond` only
    when tcfg.uncond_prob > 0). `text_context(batch)` gives the text
    conditioning (b, 77, 1024) with autograd on (the WorldModel's LLM
    conditioning); without it the OpenCLIP text encoder gives it."""
    need = {"eps", "t", "noise"} | ({"uncond"} if tcfg.uncond_prob > 0
                                    else set())
    if draws is None or not need <= draws.keys():
        raise ValueError(f"_finetune_loss: pass all of {sorted(need)} in "
                         "draws (finetune_draws)")
    cfg = model.cfg
    dev, dt = model.device, model.dtype
    with torch.no_grad():
        # clean latents: the reference SAMPLES the posterior in training
        # (ddpm3d.py:595-602)
        z = encode_video(model.first_stage_model, batch["video"].to(dev, dt),
                         scale_factor=cfg.diffusion.scale_factor,
                         eps=draws["eps"])
    if text_context is not None:
        text_ctx = text_context(batch)
    with torch.no_grad():
        if text_context is None:
            text_ctx = model.encode_text(batch["text_tokens"])
        img_ctx = model.encode_image_context(batch["cond_images"])
        z_cond = model.get_latent_z(batch["cond_frames"])
        fs = batch["fps"].to(dev, torch.int64)
        b = text_ctx.shape[0]
        if tcfg.uncond_prob > 0:
            null_ctx = model.encode_text(empty_prompt_tokens(
                b, cfg.clip_text.context_length, device=dev))
    # CFG dropout on the text conditioning only (model.py:860-868), outside
    # no_grad: the kept samples' LLM conditioning carries its gradient
    if tcfg.uncond_prob > 0:
        text_ctx = torch.where(draws["uncond"].to(dev).reshape(b, 1, 1),
                               null_ctx, text_ctx)
    ctx = torch.cat([text_ctx, img_ctx], dim=1)

    def apply(x_noisy, t):
        return model.apply_model(x_noisy, t, ctx, z_cond, fs=fs)

    return diffusion_loss(
        apply, model.schedule, z, t=draws["t"], noise=draws["noise"],
        parameterization=cfg.diffusion.parameterization,
        use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
        l_simple_weight=cfg.diffusion.l_simple_weight)


def diffusion_draws(model: DynamiCrafter, z_shape,
                    generator: torch.Generator) -> Dict:
    """The diffusion loss's draws for latents of `z_shape` (b, T, hz, wz,
    c): the timesteps, then the noise (fp32 under the dynamic rescale,
    which promotes the latents)."""
    dev = model.device
    return {"t": torch.randint(0, model.schedule.num_timesteps,
                               (z_shape[0],), generator=generator,
                               device=dev),
            "noise": torch.randn(
                tuple(z_shape), generator=generator, device=dev,
                dtype=torch.float32
                if model.cfg.diffusion.use_dynamic_rescale
                else model.dtype)}


def finetune_draws(model: DynamiCrafter, tcfg: TrainConfig,
                   video_shape, generator: torch.Generator) -> Dict:
    """The draws `_finetune_loss` takes, made from `generator` for videos
    of `video_shape` (b, T, H, W, 3): the posterior noise, the CFG dropout
    mask, then diffusion_draws at the latents' shape. The one place the
    finetune loss's randomness is drawn."""
    cfg, dev = model.cfg, model.device
    b, t, h, w = video_shape[:4]
    f = 2 ** (len(cfg.vae.channel_mult) - 1)
    shape = (b, t, h // f, w // f, cfg.vae.embed_dim)
    out = {"eps": torch.randn(shape, generator=generator, device=dev,
                              dtype=model.dtype)}
    if tcfg.uncond_prob > 0:
        out["uncond"] = torch.rand((b,), generator=generator,
                                   device=dev) < tcfg.uncond_prob
    out.update(diffusion_draws(model, shape, generator))
    return out


def _latent_loss(model: DynamiCrafter, batch: Dict[str, torch.Tensor], *,
                 draws: Dict[str, torch.Tensor]):
    """The diffusion loss over precomputed latents and conditioning (JAX
    `_latent_loss_fn`, train/step.py:218-241): batch = {z (b, T, hz, wz, 4),
    ctx (b, L, ctx_dim), z_cond (b, T, hz, wz, 4), fps (b,)}; `draws` has
    diffusion_draws' `t` and `noise`."""
    if draws is None or not {"t", "noise"} <= draws.keys():
        raise ValueError("_latent_loss: pass `t` and `noise` in draws "
                         "(diffusion_draws)")
    cfg, dev, dt = model.cfg, model.device, model.dtype
    ctx = batch["ctx"].to(dev, dt)
    z_cond = batch["z_cond"].to(dev, dt)
    fs = batch["fps"].to(dev, torch.int64)

    def apply(x_noisy, t):
        return model.apply_model(x_noisy, t, ctx, z_cond, fs=fs)

    return diffusion_loss(
        apply, model.schedule, batch["z"].to(dev, dt), t=draws["t"],
        noise=draws["noise"],
        parameterization=cfg.diffusion.parameterization,
        use_dynamic_rescale=cfg.diffusion.use_dynamic_rescale,
        l_simple_weight=cfg.diffusion.l_simple_weight)


def make_latent_finetune_step(model: DynamiCrafter, tcfg: TrainConfig,
                              mesh_spec: Optional[MeshSpec] = None,
                              fsdp: bool = False) -> Callable:
    """The `dynamicrafter` step over precomputed latents and conditioning
    (JAX train/step.py:244-257): batch = {z, ctx, z_cond, fps}. Only the
    UNet trains (reference model.py:951-965), so the frozen VAE and CLIP
    encoders run once outside the step (tools/hires_train_probe.py) and
    stay out of its memory."""
    return make_finetune_step(
        model, tcfg, stage="dynamicrafter", mesh_spec=mesh_spec, fsdp=fsdp,
        loss_fn=functools.partial(_latent_loss, model),
        draw_fn=functools.partial(diffusion_draws, model), draw_key="z")


def llm_prompt(wm: WorldModel, batch) -> MultimodalPrompt:
    """The round-1 prompt of a training batch: bos + caption ids
    (`llm_text_tokens`) around the CLIP tower's view of `cond_images`
    ([0, 1], normalised here with the CLIP mean and std)."""
    imgs = batch["cond_images"].to(wm.device)
    mean = torch.tensor(CLIP_MEAN, dtype=imgs.dtype, device=imgs.device)
    std = torch.tensor(CLIP_STD, dtype=imgs.dtype, device=imgs.device)
    return round1_prompt(batch["llm_text_tokens"].to(wm.device),
                         images=((imgs - mean) / std)[:, None],
                         prefix_len=wm.cfg.connector.image_prefix_length)


def make_wm_finetune_step(wm: WorldModel, tcfg: TrainConfig,
                          mesh_spec: Optional[MeshSpec] = None,
                          fsdp: bool = False) -> Callable:
    """The `finetune` stage (model.py:926-949 + get_batch_input :828-884):
    the text conditioning is the LLM's (get_diffusion_conditioning of the
    round-1 prompt, its last round), UNet and connector train, and CFG
    dropout swaps it for the OpenCLIP empty prompt (:860-868)."""

    def text_context(batch):
        return wm.get_diffusion_conditioning(llm_prompt(wm, batch))[:, -1]

    return make_finetune_step(
        wm, tcfg, stage="finetune", mesh_spec=mesh_spec, fsdp=fsdp,
        loss_fn=functools.partial(_finetune_loss, wm.diffusion, tcfg,
                                  text_context=text_context),
        draw_fn=functools.partial(finetune_draws, wm.diffusion, tcfg))


def make_alignment_step(wm: WorldModel, tcfg: TrainConfig,
                        mesh_spec: Optional[MeshSpec] = None,
                        fsdp: bool = False) -> Callable:
    """The `alignment` stage (model.py:886-923, config_align.yaml): the
    connector trains on the KL from the LLM conditioning to the frozen
    OpenCLIP embedding of the caption (`text_tokens`)."""

    def loss_fn(batch, *, draws=None):
        loss = wm.alignment_loss(llm_prompt(wm, batch),
                                 batch["text_tokens"].to(wm.device))
        return loss, {"loss": loss.detach()}

    return make_finetune_step(wm, tcfg, stage="alignment", loss_fn=loss_fn,
                              mesh_spec=mesh_spec, fsdp=fsdp)


def make_finetune_step(model: nn.Module, tcfg: TrainConfig,
                       stage: str = "dynamicrafter",
                       loss_fn: Optional[Callable] = None,
                       mesh_spec: Optional[MeshSpec] = None,
                       fsdp: bool = False,
                       draw_fn: Optional[Callable] = None,
                       draw_key: str = "video") -> Callable:
    """step(state, batch, *, generator=None, draws=None) -> metrics
    (0-dim tensors on the model's device: the loss's, {loss, loss_simple}
    for the diffusion loss, and grad_norm, the norm before clipping; over
    a mesh, averaged over the data axis). Updates state in place.
    `loss_fn(batch, *, draws) -> (loss, metrics)` is the stage's loss; the
    default is the `dynamicrafter` stage's, on a DynamiCrafter.
    `draw_fn(shape, generator)` makes the loss's draws for the global
    batch, `shape` being that of its `batch[draw_key]` (the default
    stage's: finetune_draws over `video`); a step with a draw_fn takes the
    `generator` or the `draws`, one without takes neither.

    With a `mesh_spec`, `batch` is this data rank's slice of the global
    batch, and `step.shard_state(state)` must have prepared the state
    (the optimizer's ZeRO-2 plan; with fsdp=True the sharded parameters,
    JAX's fsdp_param_spec over trainable, frozen and EMA leaves alike)."""
    if loss_fn is None:
        if stage != "dynamicrafter":
            raise ValueError(f"stage {stage!r} takes its own loss_fn "
                             "(make_wm_finetune_step, make_alignment_step, "
                             "train.llm_step.make_llm_sft_step)")
        loss_fn = functools.partial(_finetune_loss, model, tcfg)
        draw_fn = functools.partial(finetune_draws, model, tcfg)
    if fsdp and mesh_spec is None:
        raise ValueError("fsdp=True shards over a mesh: pass mesh_spec")
    n, rank = ((mesh_spec.n_data, mesh_spec.data_rank) if mesh_spec
               else (1, 0))
    group = mesh_spec.data_group if mesh_spec else None

    def shard_state(state: TrainState) -> TrainState:
        """The state with the mesh's layout: FSDP-sharded parameters when
        fsdp, and an optimizer (and EMA) over the parameters as they now
        are, with the ZeRO-2 plan. Load or restore weights before this."""
        if fsdp:
            apply_fsdp(state.model, mesh_spec)
        params = dict(state.model.named_parameters())
        trainable = {k: params[k] for k in state.trainable}
        return replace(state, trainable=trainable,
                       optimizer=Optimizer(trainable, tcfg, mesh_spec),
                       ema=EMA(trainable) if state.ema is not None else None)

    def step(state: TrainState, batch, *,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        if mesh_spec is not None and state.optimizer.mesh is not mesh_spec:
            raise ValueError("a mesh step takes a state prepared by its "
                             "shard_state")
        batch = {k: v if isinstance(v, MultimodalPrompt)
                 else torch.as_tensor(v) for k, v in batch.items()}
        if draw_fn is not None:
            if draws is None:
                if generator is None:
                    raise ValueError("pass a generator or the draws")
                shape = batch[draw_key].shape
                draws = draw_fn((n * shape[0], *shape[1:]), generator)
            if n > 1:
                draws = {k: shard_rows(v, n, rank) for k, v in draws.items()}
        state.optimizer.zero_grad()
        loss, metrics = loss_fn(batch, draws=draws)
        loss.backward()
        gnorm = state.optimizer.step()
        if state.ema is not None:
            state.ema.update(state.trainable, state.step,
                             decay=tcfg.ema_decay)
        state.step += 1
        if group is not None:
            metrics = mean_over(metrics, group, n)
        return {**metrics, "grad_norm": gnorm}

    step.shard_state = shard_state
    return step


def mean_over(metrics: Dict[str, torch.Tensor], group, n: int) -> Dict:
    """Each 0-dim metric averaged over the group's n ranks (fp32)."""
    vals = torch.stack([v.detach().float() for v in metrics.values()])
    dist.all_reduce(vals, group=group)
    return dict(zip(metrics, vals / n))
