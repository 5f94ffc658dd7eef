"""Optimizer and freeze policy.

Counterpart of open_pandora_tpu/train/optim.py (reference model.py:951-972
configure_optimizers, config/config.yaml:32-33): AdamW (or the 8-bit
AdamW of train/optim8bit.py) after a clip of the gradients' global norm,
with a constant or cosine learning rate. The frozen parameters get
requires_grad False, so no gradient is ever computed for them.
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.models.lora import is_adapter
from open_pandora_tpu_torch.train.optim8bit import BLOCK_SIZE, AdamW8bit

if TYPE_CHECKING:
    from open_pandora_tpu_torch.parallel.mesh import MeshSpec

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
    clipping. AdamW's moments take the parameters' dtype, as optax's do.

    With a `mesh` whose data axis has a process group, step() first
    averages the gradients over the data axis (DDP): a leaf that
    `zero2_opt_spec` shards (mesh.shard_opt_state, over more than one data
    rank) is reduce-scattered,
    this rank updates its part of the leaf and of the optimizer state
    (ZeRO-2), and the parts are all-gathered into the parameter; the other
    leaves are all-reduced and updated whole on every rank. A leaf that is
    an FSDP DTensor arrives reduced and is updated on its local shard. The
    norm and the clip are those of the whole gradient. The 8-bit state of
    a sharded leaf is a range of whole blocks of the unsharded flat leaf,
    so its numbers do not depend on the number of ranks."""

    def __init__(self, params: Params, cfg: TrainConfig,
                 mesh: Optional["MeshSpec"] = None):
        from torch.distributed.tensor import DTensor

        from open_pandora_tpu_torch.parallel.mesh import zero2_opt_spec
        self.cfg = cfg
        self.mesh = mesh
        self.params = list(params.values())
        self.count = 0
        self.group = mesh.data_group if mesh is not None else None
        eight = cfg.optimizer == "adamw8bit"
        if not eight and cfg.optimizer != "adamw":
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}; "
                             "choose adamw or adamw8bit")
        spec = {}
        if (self.group is not None and mesh.shard_opt_state
                and mesh.n_data > 1):
            # the state's leaves: the parameter's shape, or for the 8-bit
            # moments the flat leaf padded to whole blocks. On one data
            # rank a part would be the whole leaf: every leaf stays whole
            spec = zero2_opt_spec(mesh, {
                k: (-(-p.numel() // BLOCK_SIZE) * BLOCK_SIZE,) if eight
                else p.shape for k, p in params.items()})
        self.slots: List[_Slot] = []
        for name, p in params.items():
            if isinstance(p, DTensor):
                if eight:
                    raise ValueError(
                        "adamw8bit under FSDP: the 8-bit blocks would follow "
                        "the shard layout and change with the world size")
                self.slots.append(_Slot(p, "fsdp", p.to_local().detach()))
            elif spec.get(name) is None:
                self.slots.append(_Slot(p, "rep", p))
            else:
                self.slots.append(_Slot.shard(
                    p, mesh.n_data, mesh.data_rank,
                    None if eight else spec[name], BLOCK_SIZE if eight else 0))
        tensors = [s.tensor for s in self.slots]
        if eight:
            self.adamw = AdamW8bit(
                tensors, b1=cfg.adam_b1, b2=cfg.adam_b2,
                eps=cfg.adam_eps, weight_decay=cfg.weight_decay,
                block_size=BLOCK_SIZE)
        else:
            self.adamw = torch.optim.AdamW(
                tensors, lr=cfg.learning_rate,
                betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
                weight_decay=cfg.weight_decay)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for s in self.slots:   # an unused parameter's gradient is 0
            if s.param.grad is None:
                s.param.grad = torch.zeros_like(s.param)
        self._reduce()
        rep = [s.tensor.grad for s in self.slots if s.kind == "rep"]
        part = [s.tensor.grad for s in self.slots if s.kind != "rep"]
        norm = global_norm(rep) if rep else None
        if part:   # the shards' squares summed over the data axis
            sq = global_norm(part).square()
            if self.group is not None:
                dist.all_reduce(sq, group=self.group)
            norm = sq if norm is None else norm.square() + sq
            norm = norm.sqrt()
        # optax: g if norm < max_norm else g / norm * max_norm (no epsilon)
        max_norm = self.cfg.grad_clip_norm
        torch._foreach_mul_(rep + part, torch.where(
            norm >= max_norm, max_norm / norm, torch.ones_like(norm)))
        lr = lr_at(self.cfg, self.count)
        if isinstance(self.adamw, AdamW8bit):
            self.adamw.step(lr)
        else:
            for group in self.adamw.param_groups:
                group["lr"] = lr
            self.adamw.step()
        self._gather()
        for s in self.slots:   # a ZeRO-2 part's gradient is spent
            if s.kind == "shard":
                s.tensor.grad = None
        self.count += 1
        return norm

    def _reduce(self) -> None:
        """Average the gradients over the data axis (bucketed): rep leaves
        by all-reduce, sharded leaves by reduce-scatter into their slots."""
        n = self.mesh.n_data if self.mesh is not None else 1
        for s in self.slots:
            if s.kind == "fsdp":
                s.tensor.grad = s.param.grad.to_local()
        rep = [s for s in self.slots if s.kind == "rep"]
        if self.group is not None:
            for bucket in _buckets(rep, lambda s: s.param.numel()):
                flat = torch.cat([s.param.grad.reshape(-1) for s in bucket])
                dist.all_reduce(flat, group=self.group)
                flat.div_(n)
                for s, g in zip(bucket, flat.split(
                        [s.param.numel() for s in bucket])):
                    s.param.grad.copy_(g.view_as(s.param.grad))
        sharded = [s for s in self.slots if s.kind == "shard"]
        for bucket in _buckets(sharded, lambda s: n * s.k):
            full = torch.cat([s.rows(s.param.grad).view(n, s.k)
                              for s in bucket], dim=1)
            out = full.new_empty(full.shape[1])
            dist.reduce_scatter_tensor(out, full.reshape(-1),
                                       group=self.group)
            out.div_(n)
            for s, g in zip(bucket, out.split([s.k for s in bucket])):
                s.tensor.grad = g
                s.param.grad = None   # ZeRO-2 keeps only this rank's part

    def _gather(self) -> None:
        """All-gather the updated parts into the sharded parameters."""
        n = self.mesh.n_data if self.mesh is not None else 1
        sharded = [s for s in self.slots if s.kind == "shard"]
        for bucket in _buckets(sharded, lambda s: n * s.k):
            local = torch.cat([s.tensor for s in bucket])
            out = local.new_empty(n * local.numel())
            dist.all_gather_into_tensor(out, local, group=self.group)
            cols = out.view(n, -1).split([s.k for s in bucket], dim=1)
            for s, c in zip(bucket, cols):
                s.param.copy_(s.unrows(c.reshape(-1)))


# elements per collective bucket
BUCKET = 1 << 27


def _buckets(slots, size):
    """Consecutive runs of slots of one dtype, each at most BUCKET
    elements (a larger slot alone)."""
    out, cur, total = [], [], 0
    for s in slots:
        if cur and (s.param.dtype != cur[0].param.dtype
                    or total + size(s) > BUCKET):
            out.append(cur)
            cur, total = [], 0
        cur.append(s)
        total += size(s)
    return out + ([cur] if cur else [])


class _Slot:
    """What the optimizer updates for one parameter: the parameter itself
    ("rep"), an FSDP parameter's local shard ("fsdp"), or this rank's part
    of a ZeRO-2 leaf ("shard"): `k` elements of the leaf's rank-major
    layout `rows(t)` (the leaf with its sharded axis moved first, or for
    the 8-bit state its flat form padded to whole blocks per rank)."""

    def __init__(self, param, kind: str, tensor):
        self.param, self.kind, self.tensor = param, kind, tensor

    @classmethod
    def shard(cls, p, n: int, rank: int, axis: Optional[int], block: int):
        numel = p.numel()
        if axis is not None:
            moved = p.movedim(axis, 0).shape
            k = numel // n

            def rows(t):
                return t.movedim(axis, 0).reshape(-1)

            def unrows(flat):
                return flat.view(moved).movedim(0, axis)
        else:
            k = -(-numel // (n * block)) * block

            def rows(t):
                return F.pad(t.reshape(-1), (0, n * k - numel))

            def unrows(flat):
                return flat[:numel].view(p.shape)
        slot = cls(p, "shard", rows(p.detach())[rank * k:(rank + 1) * k]
                   .clone())
        slot.k, slot.rows, slot.unrows = k, rows, unrows
        return slot
