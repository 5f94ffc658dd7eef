"""Where the device time of one image-to-video clip and of one training
step goes, on one CUDA card.

Run from the repository root:

    python -m open_pandora_tpu_torch.eval.profile_step [--seed 0] [--calls 2]

Builds the full-width PandoraConfig() in bf16 with random weights and times
the three parts of `eval.inference.synthesize` at 320x512x16f:

  conditioning  text encoder, CLIP image encoder + Resampler (cond and
                zero-image uncond), VAE encode of the conditioning frame
  unet_eval     one batched-CFG UNet eval (cond and uncond as batch 2), the
                work of one DDIM step
  decode        the 16-frame VAE decode in 8-frame chunks
  train_step    one `dynamicrafter` finetune step (train.step) at batch 1:
                frozen VAE encode and encoders, the UNet forward, its
                checkpoint recompute and backward, clip and AdamW

For each part it prints one JSON line: the wall time of the first call
(`cold_wall_ms`) and the mean of `--calls` later calls (`wall_ms`), both on
the host clock around torch.cuda.synchronize() with no profiler attached;
the kernel time per call under torch.profiler (`device_ms`, the sum of every
kernel's duration); `idle_share` = 1 - device_ms / wall_ms; and the kernel
time per call by class and for the costliest kernels.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from open_pandora_tpu_torch.core.config import PandoraConfig
from open_pandora_tpu_torch.eval.inference import (build_model,
                                                   diffusion_preprocess)
from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer
from open_pandora_tpu_torch.train.step import TrainState, make_finetune_step

# (class, substrings of the lower-cased kernel name); the first match wins
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd", ("flash_bwd_dkv_kernel", "flash_bwd_dq_kernel")),
    ("small_attn_fwd", ("small_attn_fwd_kernel",)),
    ("small_attn_bwd", ("small_attn_bwd_kernel",)),
    ("packed_attn_fwd", ("packed_attn_kernel",)),
    ("fused_temporal_attn", ("fused_temporal_kernel",)),
    ("group_norm_silu", ("gn_stats_kernel", "gn_apply_kernel")),
    ("conv", ("conv", "fprop", "dgrad", "wgrad")),
    ("gemm", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce", "welford", "layer_norm", "group_norm")),
    ("copy", ("copy", "catarray", "transpose")),
    ("elementwise", ("elementwise",)),
    ("foreach", ("multi_tensor_apply",)),   # the clip and AdamW
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def _wall_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def profile_part(name: str, fn, calls: int) -> dict:
    cold = _wall_ms(fn, 1)
    wall = _wall_ms(fn, calls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_class, by_name, launches = {}, {}, 0
    for e in prof.key_averages():
        # a user annotation (the optimizer's step range) spans kernels that
        # are counted on their own
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3 / calls
        by_name[e.key] = ms
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        launches += e.count
    device = sum(by_class.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"part": name, "calls": calls, "cold_wall_ms": cold,
            "wall_ms": wall, "device_ms": device,
            "idle_share": 1.0 - device / wall,
            "kernel_launches_per_call": launches / calls,
            "by_class_ms": dict(sorted(by_class.items(),
                                       key=lambda kv: -kv[1])),
            "top_kernels_ms": [[k[:120], v] for k, v in top]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("profile_step")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calls", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    dev = torch.device("cuda")
    cfg = PandoraConfig()
    model = build_model(cfg, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev)
                        .manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    img = torch.tensor(rng.integers(0, 256, (360, 640, 3), dtype=np.uint8),
                       device=dev).float() / 255.0
    tokenizer = load_clip_tokenizer()

    def conditioning():     # as in synthesize, from the prompt string on
        tokens = torch.tensor([tokenizer(
            "a red car drives along a coastal road at sunset",
            cfg.clip_text.context_length)], device=dev)
        return model.synthesis_streams(
            text_context=model.encode_text(tokens), cond_images=img[None],
            cond_frames=diffusion_preprocess(img, (320, 512))[None, None],
            guidance_scale=7.5, fs=3)

    with torch.no_grad():
        print(json.dumps(profile_part("conditioning", conditioning,
                                      args.calls)), flush=True)
        streams = conditioning()
        gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
        z = torch.randn(streams["z_cond"].shape, generator=gen, device=dev,
                        dtype=model.dtype)
        # the batched-CFG eval of DynamiCrafter.sample: cond and uncond
        # stacked on the batch axis
        x2 = torch.cat([z, z])
        t2 = torch.full((2,), 999, dtype=torch.int64, device=dev)
        ctx2 = torch.cat([streams["cond_ctx"], streams["uncond_ctx"]])
        zc2 = torch.cat([streams["z_cond"]] * 2)
        fs2 = torch.cat([streams["fs"]] * 2)
        parts = (
            ("unet_eval", lambda: model.apply_model(x2, t2, ctx2, zc2, fs2)),
            ("decode", lambda: model.decode(z, frame_chunk=8)),
        )
        for name, fn in parts:
            print(json.dumps(profile_part(name, fn, args.calls)), flush=True)

    tcfg = cfg.train
    state = TrainState.create(model, "dynamicrafter", tcfg)
    step = make_finetune_step(model, tcfg)
    t, (h, w), c = tcfg.video_length, (tcfg.height, tcfg.width), \
        cfg.clip_vision.image_size
    video = rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    batch = {"video": video, "cond_frames": video[:, :1],
             "cond_images": rng.random((1, c, c, 3), np.float32),
             "text_tokens": np.asarray([tokenizer(
                 "synthetic clip 0", cfg.clip_text.context_length)]),
             "fps": np.asarray([8])}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    print(json.dumps(profile_part(
        "train_step", lambda: step(state, batch, generator=gen),
        args.calls)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
