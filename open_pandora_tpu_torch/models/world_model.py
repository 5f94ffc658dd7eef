"""WorldModel: the frozen ChatUniVi LLM stack (CLIP ViT-L tower, DPC-KNN
clustering, LLaMA-7B trunk), the trainable connector and the DynamiCrafter
diffusion stack.

Counterpart of open_pandora_tpu/models/world_model.py:
  - get_diffusion_conditioning: splice the clustered CLIP features into the
    token embeddings, put the learned prefix rows at the [IMG_P] positions,
    run the bare LLaMA trunk, gather the hidden states of each [IMG_P]
    block -> (rounds, 64, 4096), through the Q-Former connector ->
    (rounds, 77, 1024);
  - generate: the last round's conditioning drives image_guided_synthesis;
  - alignment_loss: KL(softmax(OpenCLIP text embedding) || softmax(LLM
    conditioning)), batchmean.

Prompts are built on the host as typed segments (tokens, image, video,
prefix), so the spliced layout is known before anything runs.

`quantize_llm` ("int8", True or "nf4") builds the LLaMA's projections
weight-only quantized (models/quant.py), the layout a quantized state dict
loads into; `models.quant.quantize_llama_(wm.llama, mode)` quantizes a
built float model in place (pipeline/chat_wm.build_world_model does, after
the weights exist). `tower_type` "eva_vit_g..." takes the EVA-ViT-g tower
(models/eva_tower.py) in place of the CLIP one, and
`use_diffusion_text_encoder` a causal CLIP text transformer over the
connector's output (`diffusion_text_encoder`).

The module's state dict has the released checkpoint's keys
(`video_model.model.layers.0.…`, `video_model.model.vision_tower.
vision_tower.vision_model.…`, `video_model.model.mm_projector.weight`,
`image_prefix.weight`, `diffusion_qformer.…`, `diffusion_model.model.
diffusion_model.…`): the submodules sit where the checkpoint has them, and
`llama`, `clip_tower`, `mm_projector`, `connector` and `diffusion` name them
as the JAX package does.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from open_pandora_tpu_torch.core.config import PandoraConfig
from open_pandora_tpu_torch.models.clip_tower import CLIPVisionTower
from open_pandora_tpu_torch.models.cluster import (project_image_tokens,
                                                   project_video_tokens)
from open_pandora_tpu_torch.models.connector import Connector
from open_pandora_tpu_torch.models.dynamicrafter import (DynamiCrafter,
                                                         _Prefix)
from open_pandora_tpu_torch.models.encoders import CLIPTextEmbeddingEncoder
from open_pandora_tpu_torch.models.eva_tower import EVAVisionTower
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM


# -- prompt layout ----------------------------------------------------------


@dataclass(frozen=True)
class TokenSegment:
    """Plain text tokens (b, n). `mask` (b, n) bool marks the real tokens
    when the segment is padded to a length bucket; None means all real."""
    ids: Any
    mask: Any = None


@dataclass(frozen=True)
class ImageSegment:
    """One image -> 112 clustered feature tokens; `index` into the prompt's
    image stack."""
    index: int


@dataclass(frozen=True)
class VideoSegment:
    """A run of consecutive frames -> 112 * ceil(T/16) clustered tokens."""
    indices: Tuple[int, ...]


@dataclass(frozen=True)
class PrefixSegment:
    """64 learned [IMG_P] rows; the hidden states here feed the connector."""
    length: int = 64


Segment = Union[TokenSegment, ImageSegment, VideoSegment, PrefixSegment]


def segment_length(cfg: PandoraConfig, seg: Segment) -> Optional[int]:
    """Spliced length of a segment (None for a TokenSegment, whose ids
    carry it)."""
    per_image = sum(cfg.cluster.spatial_rates)
    if isinstance(seg, ImageSegment):
        return per_image
    if isinstance(seg, VideoSegment):
        return per_image * max(math.ceil(
            len(seg.indices) * cfg.cluster.temporal_rate), 1)
    if isinstance(seg, PrefixSegment):
        return seg.length
    return None


@dataclass
class MultimodalPrompt:
    """Ordered segments and the CLIP image stack (b, n_images, 224, 224, 3),
    preprocessed for the ViT-L tower."""
    segments: List[Segment]
    images: Any


class MMProjector(nn.Linear):
    """mm_projector: Linear(tower width (1024 CLIP, 1408 EVA) -> LLM
    hidden)."""


_CONNECTOR_KEYS = ("image_prefix", "diffusion_qformer_proj",
                   "diffusion_query_tokens", "diffusion_qformer",
                   "diffusion_proj")


def _connector_keys_out(module, state_dict, prefix, local_metadata):
    """The checkpoint holds the connector's tensors at the top level."""
    old = f"{prefix}connector."
    for key in [k for k in state_dict if k.startswith(old)]:
        state_dict[prefix + key[len(old):]] = state_dict.pop(key)


def _connector_keys_in(module, state_dict, prefix, *args):
    for key in [k for k in state_dict if k.startswith(prefix)]:
        rest = key[len(prefix):]
        if rest.split(".", 1)[0] in _CONNECTOR_KEYS:
            state_dict[f"{prefix}connector.{rest}"] = state_dict.pop(key)


class WorldModel(nn.Module):
    """The composite. Construct it on the meta device and materialise it
    with `to_empty` (`pipeline.chat_wm.build_world_model` does), then load
    weights or call core.init.init_random_."""

    def __init__(self, cfg: PandoraConfig, quantize_llm=False):
        super().__init__()
        self.cfg = cfg
        self.diffusion_model = DynamiCrafter(cfg)
        self.video_model = LlamaForCausalLM(cfg.llama, quantize_llm)
        trunk = self.video_model.model
        # the tower by name (ChatUniVi multimodal_encoder/builder.py): the
        # EVA tower's keys sit directly under vision_tower.vision_tower
        if cfg.clip_tower.tower_type.startswith("eva_vit_g"):
            trunk.vision_tower = _Prefix(
                vision_tower=EVAVisionTower(cfg.clip_tower))
        else:
            trunk.vision_tower = _Prefix(vision_tower=_Prefix(
                vision_model=CLIPVisionTower(cfg.clip_tower)))
        trunk.mm_projector = MMProjector(cfg.clip_tower.width,
                                         cfg.llama.hidden_size)
        self.connector = Connector(cfg.connector, cfg.qformer)
        if cfg.connector.use_diffusion_text_encoder:
            self.diffusion_text_encoder = CLIPTextEmbeddingEncoder(
                cfg.clip_text)
        self.register_state_dict_post_hook(_connector_keys_out)
        self.register_load_state_dict_pre_hook(_connector_keys_in)

    # the JAX package's names for the parts
    @property
    def diffusion(self) -> DynamiCrafter:
        return self.diffusion_model

    @property
    def llama(self) -> LlamaForCausalLM:
        return self.video_model

    @property
    def clip_tower(self) -> Union[CLIPVisionTower, EVAVisionTower]:
        tower = self.video_model.model.vision_tower.vision_tower
        return getattr(tower, "vision_model", tower)

    @property
    def text_embedding_encoder(self) -> Optional[CLIPTextEmbeddingEncoder]:
        return getattr(self, "diffusion_text_encoder", None)

    @property
    def quantize_llm(self):
        """False, "int8" or "nf4": the LLaMA's projections as they are."""
        return self.video_model.quantized

    @property
    def mm_projector(self) -> MMProjector:
        return self.video_model.model.mm_projector

    @property
    def dtype(self) -> torch.dtype:
        return self.connector.diffusion_query_tokens.dtype

    @property
    def device(self) -> torch.device:
        return self.connector.diffusion_query_tokens.device

    # -- conditioning path --------------------------------------------------

    def encode_tower(self, images: torch.Tensor) -> torch.Tensor:
        """(n, 224, 224, 3) -> (n, 256, 1024) patch features."""
        return self.clip_tower(images.to(self.device, self.dtype))

    def _batch(self, prompt: MultimodalPrompt) -> int:
        return prompt.images.shape[0] if prompt.images is not None else 1

    def build_inputs_embeds(self, prompt: MultimodalPrompt,
                            timings: Optional[dict] = None
                            ) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
        """Splice the segments into (b, L, hidden) embeddings. Returns them
        and the (start, length) of each prefix segment."""
        cfg, dev = self.cfg, self.device
        b = self._batch(prompt)
        t0 = _mark(timings, dev)
        feats = None
        if prompt.images is not None and prompt.images.shape[1]:
            images = torch.as_tensor(prompt.images)
            feats = self.encode_tower(images.flatten(0, 1))
            feats = feats.unflatten(0, images.shape[:2])
        t1 = _mark(timings, dev)

        embeds, prefix_spans, pos = [], [], 0
        for seg in prompt.segments:
            if isinstance(seg, TokenSegment):
                e = self.llama.embed(torch.as_tensor(seg.ids, device=dev))
            elif isinstance(seg, ImageSegment):
                e = self.mm_projector(project_image_tokens(
                    feats[:, seg.index], cfg.cluster.spatial_rates))
            elif isinstance(seg, VideoSegment):
                idx = list(seg.indices)
                e = self.mm_projector(torch.cat([
                    project_video_tokens(fb[idx], cfg.cluster.spatial_rates,
                                         cfg.cluster.temporal_rate)
                    for fb in feats]))
            elif isinstance(seg, PrefixSegment):
                rows = self.connector.prefix_embeddings().to(self.dtype)
                if rows.shape[0] != seg.length:
                    raise ValueError(f"prefix of {seg.length} rows, the "
                                     f"connector holds {rows.shape[0]}")
                e = rows[None].expand(b, -1, -1)
                prefix_spans.append((pos, seg.length))
            else:
                raise TypeError(f"unknown segment {seg!r}")
            embeds.append(e)
            pos += e.shape[1]
        out = torch.cat(embeds, dim=1)
        if timings is not None:
            timings.update(tower_s=t1 - t0,
                           cluster_s=_mark(timings, dev) - t1)
        return out, prefix_spans

    def segment_length(self, seg: Segment) -> Optional[int]:
        return segment_length(self.cfg, seg)

    def attention_mask_for(self, prompt: MultimodalPrompt
                           ) -> Optional[torch.Tensor]:
        """(b, L) bool key mask over the spliced sequence, or None when no
        TokenSegment is bucketed. Feature and prefix spans are all real."""
        if not any(isinstance(s, TokenSegment) and s.mask is not None
                   for s in prompt.segments):
            return None
        b, dev = self._batch(prompt), self.device
        cols = []
        for seg in prompt.segments:
            if isinstance(seg, TokenSegment) and seg.mask is not None:
                cols.append(torch.as_tensor(seg.mask, device=dev).bool())
            elif isinstance(seg, TokenSegment):
                cols.append(torch.ones(tuple(seg.ids.shape), dtype=torch.bool,
                                       device=dev))
            else:
                cols.append(torch.ones((b, self.segment_length(seg)),
                                       dtype=torch.bool, device=dev))
        return torch.cat(cols, dim=1)

    def get_diffusion_conditioning(
            self, prompt: MultimodalPrompt,
            attention_mask: Optional[torch.Tensor] = None,
            timings: Optional[dict] = None) -> torch.Tensor:
        """-> (b, rounds, 77, 1024) diffusion conditioning, one entry per
        [IMG_P] block. If a `timings` dict is given, the device is
        synchronised between the parts and it receives tower_s, cluster_s
        (clustering and splice), prefill_s, connector_s and prompt_len."""
        dev = self.device
        if attention_mask is None:
            attention_mask = self.attention_mask_for(prompt)
        embeds, spans = self.build_inputs_embeds(prompt, timings)
        t0 = _mark(timings, dev)
        positions = None
        if attention_mask is not None:
            # pads are position-transparent: real tokens keep the positions
            # they would have unpadded, so bucketed == unbucketed
            attention_mask = attention_mask.to(dev)
            positions = torch.cumsum(attention_mask.int(), dim=1) - 1
        hidden = self.llama.trunk(embeds, positions, attention_mask)
        t1 = _mark(timings, dev)
        stacked = torch.stack([hidden[:, s:s + n] for s, n in spans], dim=1)
        b, R = stacked.shape[:2]                      # (b, R, 64, hidden)
        cond = self.connector(stacked.flatten(0, 1))
        if self.text_embedding_encoder is not None:
            cond = self.text_embedding_encoder(cond)
        if timings is not None:
            timings.update(prefill_s=t1 - t0,
                           connector_s=_mark(timings, dev) - t1,
                           prompt_len=embeds.shape[1])
        return cond.unflatten(0, (b, R))

    # -- generation ---------------------------------------------------------

    def generate(self, prompt: MultimodalPrompt, *, cond_images: torch.Tensor,
                 cond_frames: torch.Tensor, ddim_steps: int = 50,
                 guidance_scale: float = 4.0, eta: float = 1.0, fs: int = 15,
                 **kw) -> torch.Tensor:
        """The last round's conditioning drives the synthesis: latents
        (b, T, h/8, w/8, 4). `kw` goes to image_guided_synthesis
        (generator, x_T, noise, guidance_rescale, ...)."""
        cond = self.get_diffusion_conditioning(prompt)[:, -1]
        return self.diffusion.image_guided_synthesis(
            text_context=cond, cond_images=cond_images,
            cond_frames=cond_frames, ddim_steps=ddim_steps,
            guidance_scale=guidance_scale, eta=eta, fs=fs, **kw)

    # -- alignment ----------------------------------------------------------

    def alignment_loss(self, prompt: MultimodalPrompt,
                       caption_tokens: torch.Tensor) -> torch.Tensor:
        """KL(softmax(clip_text(caption)) || softmax(llm_cond)) summed over
        tokens and features, over the batch size."""
        llm_cond = self.get_diffusion_conditioning(prompt)[:, -1]
        clip_cond = self.diffusion.encode_text(caption_tokens)
        log_p = F.log_softmax(llm_cond.float(), dim=-1)
        q = F.softmax(clip_cond.float(), dim=-1)
        kl = (q * (torch.log(q.clamp_min(1e-12)) - log_p)).sum(dim=-1)
        return kl.sum() / llm_cond.shape[0]


def _mark(timings: Optional[dict], device: torch.device) -> float:
    if timings is None:
        return 0.0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


# -- prompt builders (the product grammar) ----------------------------------


def round1_prompt(bos_and_text_ids, *, images, prefix_len: int = 64,
                  text_mask=None) -> MultimodalPrompt:
    """`bos + "<image> " + text + "[IMG_P]" * 64`. bos_and_text_ids (b, n):
    bos, then the text (the "<image>" marker is structural, not a token
    here). text_mask (b, n): the real-token mask when the ids are padded to
    a length bucket."""
    bos = TokenSegment(bos_and_text_ids[:, :1])
    text = TokenSegment(bos_and_text_ids[:, 1:],
                        None if text_mask is None else text_mask[:, 1:])
    return MultimodalPrompt(
        segments=[bos, ImageSegment(0), text, PrefixSegment(prefix_len)],
        images=images)


def next_round_prompt(history: MultimodalPrompt,
                      new_frame_indices: Sequence[int], text_ids, *,
                      prefix_len: int = 64, text_mask=None
                      ) -> MultimodalPrompt:
    """Append `"<image>" * 16 + text + "[IMG_P]" * 64`: the 16 decoded
    frames re-enter as a video segment."""
    segs = list(history.segments)
    segs.append(VideoSegment(tuple(new_frame_indices)))
    segs.append(TokenSegment(text_ids, text_mask))
    segs.append(PrefixSegment(prefix_len))
    return MultimodalPrompt(segments=segs, images=history.images)
