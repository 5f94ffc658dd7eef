"""Optimizer and freeze policy.

Counterpart of open_pandora_tpu/train/optim.py (reference model.py:951-972
configure_optimizers, config/config.yaml:32-33): AdamW after a clip of the
gradients' global norm, with a constant or cosine learning rate. The
frozen sub-models get requires_grad False and run under torch.no_grad(),
so no gradient is ever computed for them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from open_pandora_tpu_torch.core.config import TrainConfig

# the modules that train, per stage, by their prefix in the reference state
# dict (the JAX package's top-level params keys: "dynamicrafter" trains
# ("unet",)); the LLM stages wait for slice B
TRAINABLE_KEYS = {
    "dynamicrafter": ("model.diffusion_model",),
}

Params = Dict[str, torch.Tensor]


def trainable_partition(model: nn.Module, stage: str) -> Tuple[Params,
                                                                  Params]:
    """Split the named parameters into (trainable, frozen) by stage, set
    requires_grad to match, and put the trainable modules in training mode
    and every other module in eval mode."""
    prefixes = TRAINABLE_KEYS[stage]
    model.eval()
    for prefix in prefixes:
        model.get_submodule(prefix).train()
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        train = name.startswith(tuple(f"{x}." for x in prefixes))
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
    `params`: step() clips the gradients (in place), applies AdamW at the
    scheduled rate and returns the norm before clipping. The moments take
    the parameters' dtype, as optax's do."""

    def __init__(self, params: Params, cfg: TrainConfig):
        if cfg.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r}: only adamw is ported")
        self.cfg = cfg
        self.params = list(params.values())
        self.count = 0
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate,
            betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)

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
        for group in self.adamw.param_groups:
            group["lr"] = lr_at(self.cfg, self.count)
        self.adamw.step()
        self.count += 1
        return norm
