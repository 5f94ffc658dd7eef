"""ChatWM: the multi-round interactive session.

Counterpart of open_pandora_tpu/pipeline/chat_wm.py:
  - round 1 (generate_video): prompt `bos + "<image> " + text +
    "[IMG_P]" * 64`; the image is preprocessed for both towers and the
    diffusion branch;
  - rounds 2.. (generate_video_next_round): the prompt history plus
    `"<image>" * 16 + text + "[IMG_P]" * 64`; the decoded frames cross the
    pixel domain (decode -> uint8 -> preprocess again), the last 4 frames
    become the next round's VAE conditioning; the CLIP cross-attention image
    stays round 1's;
  - generate_video_multiround concatenates the rounds, trimming the 4-frame
    overlap of each.
Images are NumPy arrays (H, W, 3), uint8 or float in [0, 1]; frames come
back as uint8 (T, H, W, 3). The sampler is a host loop, so any number of
DDIM steps is one call.

`save_video` writes the session as an mp4 (OpenCV, imported then). The
user's entry points are pipeline/cli.py and pipeline/server.py.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from open_pandora_tpu_torch.core.config import (CLIPTowerConfig,
                                                ClusterConfig,
                                                ConnectorConfig, LLaMAConfig,
                                                PandoraConfig, QFormerConfig)
from open_pandora_tpu_torch.core.init import init_random_
from open_pandora_tpu_torch.models.world_model import (MultimodalPrompt,
                                                       WorldModel,
                                                       next_round_prompt,
                                                       round1_prompt)
from open_pandora_tpu_torch.pipeline.preprocess import (
    clip_resampler_preprocess, clip_tower_preprocess, diffusion_preprocess)
from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer
from open_pandora_tpu_torch.utils.video_io import (concat_rounds,
                                                   frames_to_uint8,
                                                   write_video)


def build_world_model(cfg: PandoraConfig, *, device="cuda",
                      dtype=torch.float32,
                      generator: Optional[torch.Generator] = None
                      ) -> WorldModel:
    """WorldModel allocated on `device` in `dtype`, straight from the meta
    device (at full width the LLaMA alone is 6.7 B parameters); random
    weights from `generator` (on `device`) when given, else uninitialised
    storage for a checkpoint to fill."""
    with torch.device("meta"):
        wm = WorldModel(cfg)
    wm = wm.to(dtype=dtype).to_empty(device=device).eval()
    if generator is not None:
        init_random_(wm, generator)
    return wm


class ChatWM:
    TEXT_BUCKETS = (16, 32, 64, 128, 256)

    def __init__(self, wm: WorldModel, tokenizer=None, height: int = 320,
                 width: int = 512):
        self.wm = wm
        self.tokenizer = tokenizer or load_tokenizer()
        self.hw = (height, width)
        self.reset()

    def reset(self) -> None:
        self.prompt: Optional[MultimodalPrompt] = None
        self.images: List[torch.Tensor] = []        # CLIP-tower stack
        self.round_videos: List[np.ndarray] = []    # uint8 (16, h, w, 3)
        self.cond_image = None                      # round 1's image
        self.round = 0
        # per round: conditioning_s (of it tower_s, cluster_s, prefill_s,
        # connector_s), encoders_s, sampling_s, step_s, decode_s, prompt_len
        self.round_times: List[dict] = []

    # -- rounds -------------------------------------------------------------

    def _ids(self, text: str, add_bos: bool):
        """Tokenize and pad to a length bucket: (ids (1, bucket), mask
        (1, bucket)). Pads are masked and position-transparent in the
        trunk, so bucketing changes no value; beyond the largest bucket the
        length is exact."""
        raw = self.tokenizer.encode(text, add_bos=add_bos)
        n = len(raw)
        bucket = next((b for b in self.TEXT_BUCKETS if b >= n), n)
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = raw
        mask = np.zeros((1, bucket), bool)
        mask[0, :n] = True
        return torch.from_numpy(ids), torch.from_numpy(mask)

    def generate_video(self, image: np.ndarray, text: str, *,
                       ddim_steps: int = 50, fs: int = 15,
                       guidance_scale: float = 4.0, eta: float = 1.0,
                       seed: int = 0, **kw) -> np.ndarray:
        """Round 1. Returns uint8 frames (T, H, W, 3)."""
        self.reset()
        dev = self.wm.device
        tower_size = self.wm.cfg.clip_tower.image_size
        self.images = [clip_tower_preprocess(image, tower_size, dev)]
        self.cond_image = clip_resampler_preprocess(image, dev)[None]
        cond_frames = diffusion_preprocess(image, self.hw, dev)[None, None]

        ids, mask = self._ids(text, add_bos=True)
        self.prompt = round1_prompt(
            ids, images=torch.stack(self.images)[None],
            prefix_len=self.wm.cfg.connector.image_prefix_length,
            text_mask=mask)
        return self._run_round(cond_frames, ddim_steps, fs, guidance_scale,
                               eta, seed, **kw)

    def generate_video_next_round(self, text: str, *, ddim_steps: int = 50,
                                  fs: int = 15, guidance_scale: float = 4.0,
                                  eta: float = 1.0, seed: int = 0,
                                  **kw) -> np.ndarray:
        """Rounds 2+: chain the last decoded clip."""
        if self.round < 1:
            raise RuntimeError("call generate_video first")
        dev = self.wm.device
        last = self.round_videos[-1]                 # uint8 (16, h, w, 3)
        start = len(self.images)
        self.images.extend(clip_tower_preprocess(
            last, self.wm.cfg.clip_tower.image_size, dev))
        new_indices = tuple(range(start, len(self.images)))
        # the last 4 frames -> VAE conditioning, through the pixel domain
        tail = last[-4:].astype(np.float32) / 127.5 - 1.0
        cond_frames = torch.from_numpy(tail)[None]   # (1, 4, H, W, 3)

        ids, mask = self._ids(text, add_bos=False)
        prompt = next_round_prompt(
            self.prompt, new_indices, ids,
            prefix_len=self.wm.cfg.connector.image_prefix_length,
            text_mask=mask)
        self.prompt = MultimodalPrompt(segments=prompt.segments,
                                       images=torch.stack(self.images)[None])
        return self._run_round(cond_frames, ddim_steps, fs, guidance_scale,
                               eta, seed, **kw)

    def _run_round(self, cond_frames, ddim_steps, fs, guidance_scale, eta,
                   seed, *, cfg_img=None, uncond_text_context=None,
                   **sample_kw) -> np.ndarray:
        """`sample_kw` goes to the sampler (guidance_rescale,
        timestep_spacing, x_T, noise)."""
        wm, dev = self.wm, self.wm.device

        def mark():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            return time.perf_counter()

        times = {}
        with torch.no_grad():
            t0 = mark()
            text_ctx = wm.get_diffusion_conditioning(
                self.prompt, timings=times)[:, -1]
            t1 = mark()
            streams = wm.diffusion.synthesis_streams(
                text_context=text_ctx, cond_images=self.cond_image,
                cond_frames=cond_frames, guidance_scale=guidance_scale,
                uncond_text_context=uncond_text_context, cfg_img=cfg_img,
                fs=fs)
            t2 = mark()
            z = wm.diffusion.sample(
                streams, ddim_steps=ddim_steps,
                guidance_scale=guidance_scale, eta=eta, cfg_img=cfg_img,
                generator=torch.Generator(device=dev).manual_seed(
                    seed + self.round), **sample_kw)
            t3 = mark()
            # frames decode in chunks: 8 at 320x512, 2 above
            t = z.shape[1]
            chunk = (8 if self.hw[0] * self.hw[1] <= 320 * 512 and t % 8 == 0
                     else (2 if t % 2 == 0 else 1))
            video = wm.diffusion.decode(z, frame_chunk=chunk)
            frames = frames_to_uint8(video[0].float().cpu().numpy())
            t4 = mark()
        times.update(conditioning_s=t1 - t0, encoders_s=t2 - t1,
                     sampling_s=t3 - t2, step_s=(t3 - t2) / ddim_steps,
                     decode_s=t4 - t3)
        print(f"[chatwm] round {self.round}: conditioning {t1 - t0:.2f}s, "
              f"sampling {t3 - t1:.2f}s, decode {t4 - t3:.2f}s", flush=True)
        self.round_times.append(times)
        self.round_videos.append(frames)
        self.round += 1
        return frames

    def generate_video_multiround(self, image: np.ndarray, texts: List[str],
                                  **kw) -> np.ndarray:
        """One clip per action text, chained."""
        self.generate_video(image, texts[0], **kw)
        for t in texts[1:]:
            self.generate_video_next_round(t, **kw)
        return concat_rounds(self.round_videos)

    # -- output -------------------------------------------------------------

    def save_video(self, path: str, frames: Optional[np.ndarray] = None,
                   fps: int = 8) -> str:
        """Write `frames` (uint8 (T, H, W, 3)), by default the session's
        rounds with their overlaps trimmed, as an mp4 (OpenCV)."""
        if frames is None:
            frames = concat_rounds(self.round_videos)
        return write_video(path, frames, fps=fps)


def debug_world_config(t: int = 4) -> PandoraConfig:
    """The tiny configuration of the --debug smoke run: 32x32 frames, 56x56
    tower images of 16 patches clustered 8 -> 4 -> 3 (no stage has fewer
    clusters than its k neighbours, where the centers would hang on
    rounding), 4 frames a round in one event."""
    from open_pandora_tpu_torch.eval.inference import debug_config
    return dataclasses.replace(
        debug_config(t),
        llama=LLaMAConfig(vocab_size=32000, hidden_size=64,
                          intermediate_size=128, num_layers=2, num_heads=4),
        clip_tower=CLIPTowerConfig(image_size=56, patch_size=14, width=64,
                                   layers=2, heads=2),
        cluster=ClusterConfig(spatial_rates=(8, 4, 3), temporal_rate=0.25),
        qformer=QFormerConfig(hidden_size=32, num_layers=2, num_heads=2,
                              intermediate_size=64, num_query_tokens=7),
        connector=ConnectorConfig(llm_hidden=64, image_prefix_length=4,
                                  qformer_proj_dim=32, proj_out_dim=64))

