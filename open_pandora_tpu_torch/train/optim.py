"""Optimizer and freeze policy.

Counterpart of open_pandora_tpu/train/optim.py (reference model.py:951-972
configure_optimizers, config/config.yaml:32-33): AdamW (or the 8-bit
AdamW of train/optim8bit.py) after a clip of the gradients' global norm,
with a constant or cosine learning rate. The frozen parameters get
requires_grad False, so no gradient is ever computed for them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.models.lora import is_adapter
from open_pandora_tpu_torch.train.optim8bit import AdamW8bit

_UNET = "diffusion_model.model.diffusion_model"
_LLAMA = ("video_model.model.embed_tokens", "video_model.model.layers",
          "video_model.model.norm", "video_model.lm_head")
_MM_PROJECTOR = "video_model.model.mm_projector"

# the modules that train, per stage, by module path: "dynamicrafter" in a
# DynamiCrafter, the others in a WorldModel (the JAX package's top-level
# params keys: dynamicrafter ("unet",), finetune ("unet", "connector"),
# alignment ("connector",), llm_sft ("llama", "mm_projector")). The
# WorldModel holds the CLIP tower and mm_projector inside
# `video_model.model`, so "llama" is named by its own parts and the tower
# stays frozen, as in JAX. LoRA SFT trains mm_projector and every adapter
# (JAX _lora_pred; ChatUniVi train.py:121-146).
TRAINABLE_KEYS = {
    "dynamicrafter": ("model.diffusion_model",),
    "finetune": (_UNET, "connector"),
    "alignment": ("connector",),
    "llm_sft": _LLAMA + (_MM_PROJECTOR,),
    "llm_sft_lora": (_MM_PROJECTOR,),
}

Params = Dict[str, torch.Tensor]


def trainable_partition(model: nn.Module, stage: str) -> Tuple[Params,
                                                                  Params]:
    """Split the named parameters into (trainable, frozen) by stage, set
    requires_grad to match, and put the modules that train in training
    mode and every other module in eval mode."""
    modules = TRAINABLE_KEYS[stage]
    model.eval()
    for prefix in modules:
        model.get_submodule(prefix).train()
    prefixes = tuple(f"{x}." for x in modules)
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        train = name.startswith(prefixes) or (stage == "llm_sft_lora"
                                              and is_adapter(name))
        p.requires_grad_(train)
        (trainable if train else frozen)[name] = p
    return trainable, frozen


def lr_at(cfg: TrainConfig, count: int) -> float:
    """The learning rate of update `count` (0-based): constant, or
    CosineAnnealingLR to min_lr over max_steps (optax's
    cosine_decay_schedule)."""
    if cfg.lr_schedule == "cosine":
        frac = min(count, cfg.max_steps) / cfg.max_steps
        alpha = cfg.min_lr / cfg.learning_rate
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha
        return cfg.learning_rate * decayed
    if cfg.lr_schedule != "constant":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    return cfg.learning_rate


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, in fp32."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(tensors, 2, dtype=torch.float32)))


class Optimizer:
    """optax.chain(clip_by_global_norm(grad_clip_norm), adamw(...)) over
    `params`: step() clips the gradients (in place), applies AdamW (or the
    8-bit AdamW) at the scheduled rate and returns the norm before
    clipping. AdamW's moments take the parameters' dtype, as optax's do."""

    def __init__(self, params: Params, cfg: TrainConfig):
        self.cfg = cfg
        self.params = list(params.values())
        self.count = 0
        if cfg.optimizer == "adamw8bit":
            self.adamw = AdamW8bit(
                self.params, b1=cfg.adam_b1, b2=cfg.adam_b2,
                eps=cfg.adam_eps, weight_decay=cfg.weight_decay)
        elif cfg.optimizer == "adamw":
            self.adamw = torch.optim.AdamW(
                self.params, lr=cfg.learning_rate,
                betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                weight_decay=cfg.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}; "
                             "choose adamw or adamw8bit")

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:   # an unused parameter's gradient is 0
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = global_norm(grads)
        # optax: g if norm < max_norm else g / norm * max_norm (no epsilon)
        max_norm = self.cfg.grad_clip_norm
        torch._foreach_mul_(grads, torch.where(
            norm >= max_norm, max_norm / norm, torch.ones_like(norm)))
        lr = lr_at(self.cfg, self.count)
        if isinstance(self.adamw, AdamW8bit):
            self.adamw.step(lr)
        else:
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
        self.count += 1
        return norm
