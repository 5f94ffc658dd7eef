"""ChatUniVi's supervised finetuning of the LLM: next-token cross-entropy
over the spliced multimodal sequence.

Counterpart of open_pandora_tpu/train/llm_step.py (reference
ChatUniVi/train/train.py:850-1082; labels at image positions are
IGNORE_INDEX, constants.py and arch.py's label splice). The product's
training keeps the LLM frozen; this stage (re)trains the ChatUniVi base:
LLaMA and mm_projector in full, or, with `llama.lora_rank > 0`, the LoRA
adapters and mm_projector (stage `llm_sft_lora`). The vision tower and the
clustering stay frozen.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.data.sft import IGNORE_INDEX
from open_pandora_tpu_torch.models.world_model import (MultimodalPrompt,
                                                       TokenSegment,
                                                       WorldModel)
from open_pandora_tpu_torch.parallel.mesh import MeshSpec
from open_pandora_tpu_torch.train.step import make_finetune_step


def sft_stage(wm: WorldModel) -> str:
    """The partition key of the SFT stage: LoRA when the LLaMA has
    adapters (its config's lora_rank > 0)."""
    return "llm_sft_lora" if wm.llama.cfg.lora_rank > 0 else "llm_sft"


def build_labels(wm: WorldModel, prompt: MultimodalPrompt,
                 supervise_from: int = 0) -> torch.Tensor:
    """Labels aligned with build_inputs_embeds' output: token positions
    carry their ids, image, video and prefix spans IGNORE_INDEX. The first
    `supervise_from` token segments (the instruction text) are masked as
    the conversation preprocessing masks the human turns."""
    b = prompt.images.shape[0] if prompt.images is not None else 1
    cols, tok_seg = [], 0
    for seg in prompt.segments:
        if isinstance(seg, TokenSegment):
            ids = torch.as_tensor(seg.ids).long()
            cols.append(torch.full_like(ids, IGNORE_INDEX)
                        if tok_seg < supervise_from else ids)
            tok_seg += 1
        else:
            cols.append(torch.full((b, wm.segment_length(seg)), IGNORE_INDEX,
                                   dtype=torch.int64))
    return torch.cat(cols, dim=1)


def sft_loss(wm: WorldModel, batch, group=None, **_):
    """batch: {'prompt': MultimodalPrompt, 'labels': (b, L) int} ->
    (loss, {loss, n_supervised}). Pads (mid-sequence ones included, where
    chunk columns pad to the batch's longest) are masked out of attention
    and position-transparent, as in get_diffusion_conditioning.

    With a data-axis `group` the batch is this rank's slice: the loss is
    normalised by the global batch's supervised count and scaled by the
    group's size, so the mean over the ranks is the global batch's loss
    (and so are the averaged gradients)."""
    prompt = batch["prompt"]
    labels = torch.as_tensor(batch["labels"]).to(wm.device).long()
    embeds, _ = wm.build_inputs_embeds(prompt)
    attention_mask = wm.attention_mask_for(prompt)
    positions = None
    if attention_mask is not None:
        positions = torch.cumsum(attention_mask.int(), dim=1) - 1
    hidden = wm.llama.trunk(embeds, positions, attention_mask)
    logits = wm.llama.lm_head(hidden)[:, :-1]
    # next token: position t predicts labels[t + 1]
    targets = labels[:, 1:]
    mask = targets != IGNORE_INDEX
    ll = F.cross_entropy(logits.float().flatten(0, 1),
                         torch.where(mask, targets, 0).flatten(),
                         reduction="none").view(targets.shape)
    total = (ll * mask).sum()
    if group is None:
        denom = mask.sum().clamp_min(1)
        loss = total / denom
    else:
        denom = mask.sum()
        dist.all_reduce(denom, group=group)
        denom = denom.clamp_min(1)
        loss = total / denom * dist.get_world_size(group)
    return loss, {"loss": loss.detach(), "n_supervised": denom}


def make_llm_sft_step(wm: WorldModel, tcfg: TrainConfig,
                      mesh_spec: Optional[MeshSpec] = None,
                      fsdp: bool = False) -> Callable:
    """The SFT step on make_finetune_step: full (LLaMA + mm_projector) by
    default, the adapters + mm_projector when the LLaMA has LoRA adapters
    (ChatUniVi train.py:98-103); TrainState.create takes sft_stage(wm).
    fsdp=True stores the large LLaMA weights sharded over the data axis
    (the reference's FSDP-wrapped trainer, ChatUniVi/train/train.py:974):
    full SFT at 7B does not fit replicated."""
    group = mesh_spec.data_group if mesh_spec is not None else None
    return make_finetune_step(
        wm, tcfg, stage=sft_stage(wm), mesh_spec=mesh_spec, fsdp=fsdp,
        loss_fn=functools.partial(sft_loss, wm, group=group))
