"""Where the device time of one image-to-video clip, of one training step
and of one LLM-conditioned round at 576x1024 goes, on one CUDA card.

Run from the repository root:

    python -m open_pandora_tpu_torch.eval.profile_step [--seed 0] [--calls 2]
        [--flags ENABLE_PCONV2[,...]] [--head-channels 80]
        [--train-hw 576x1024]

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

Then it builds the full-width WorldModel (LLaMA-7B, CLIP ViT-L tower,
Q-Former connector and the same diffusion stack) and times, at 576x1024:

  conditioning_llm_round1 / _round2   `get_diffusion_conditioning` of a
                ChatWM prompt: tower, clustering, prefill, connector (round
                1: one image, 192 spliced rows; round 2: 17 images, 384)
  unet_eval_576x1024   one batched-CFG UNet eval on a 72x128 latent
  decode_576x1024      the 16-frame VAE decode in 2-frame chunks

For each part it prints one JSON line: the wall time of the first call
(`cold_wall_ms`) and the mean of `--calls` later calls (`wall_ms`), both on
the host clock around torch.cuda.synchronize() with no profiler attached;
the kernel time per call under torch.profiler (`device_ms`, the sum of every
kernel's duration); `idle_share` = 1 - device_ms / wall_ms; and the kernel
time per call by class and for the costliest kernels.

With --flags (PANDORA_* names, the prefix optional, comma-separated) it
profiles only the CFG UNet eval, at 320x512 and then on a 72x128 latent
(576x1024), each on the default route and with those flags set
(core/flags.py; the part's name and its `flags` key say which), in the
order default, flagged, flagged, default: an A/B of the opt-in conv routes
against the library convolution on one card.

With --train-hw HxW it profiles only the train_step, at that frame size
(576x1024 is configs/finetune_1024.yaml's; chip_smoke.py phase 10 runs
that config's finetune through the trainer), then runs one more step
reading the peak memory at every UNet layer's entry (`peak_by_layer`):
the intervals between two entries whose peak is highest.

With --head-channels N it builds the UNet with heads N wide
(`num_head_channels`; 80 is chip_smoke.py's phase 5b, whose attn2 takes the
dual cross-attention kernel) and profiles only the conditioning and the
320x512 CFG UNet eval.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.core.config import PandoraConfig
from open_pandora_tpu_torch.eval.inference import (build_model,
                                                   diffusion_preprocess)
from open_pandora_tpu_torch.pipeline.tokenizers import load_clip_tokenizer
from open_pandora_tpu_torch.train.step import TrainState, make_finetune_step

# (class, substrings of the lower-cased kernel name); the first match wins
KERNEL_CLASSES = (
    ("flash_fwd", ("flash_fwd_f32_kernel", "flash_fwd_f32_wide_kernel",
                   "flash_fwd_tc_kernel", "flash_fwd_wide_kernel")),
    ("flash_bwd", ("flash_bwd_dkv_f32_kernel", "flash_bwd_dq_f32_kernel",
                   "flash_bwd_dkv_tc_kernel", "flash_bwd_dq_tc_kernel")),
    ("small_attn_fwd", ("small_attn_fwd_f32_kernel", "small_attn_fwd_kernel",
                        "small_attn_fwd_tc_kernel")),
    ("small_attn_bwd", ("small_attn_bwd_f32_kernel", "small_attn_bwd_kernel",
                        "small_attn_bwd_tc_kernel")),
    ("packed_attn_fwd", ("packed_attn_kernel",)),   # both regimes
    ("dual_cross_attn", ("dual_cross_tc_kernel",)),
    ("fused_temporal_attn", ("fused_temporal_kernel",
                             "fused_temporal_tc_kernel")),
    ("group_norm_silu", ("gn_stats_kernel", "gn_apply_kernel")),
    ("conv3x3", ("conv3x3_wg_kernel", "conv3x3_tf32_kernel")),  # both rows
    ("fused_geglu", ("geglu_ln_kernel", "geglu_gemm_kernel",
                     "geglu_tf32_kernel")),
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
    p.add_argument("--flags", default="",
                   help="comma-separated PANDORA_* flags: profile only the "
                   "UNet eval (320x512, 576x1024), without and with them")
    p.add_argument("--head-channels", type=int, default=None,
                   help="profile only the 320x512 UNet eval of a UNet with "
                   "heads this wide")
    p.add_argument("--train-hw", default=None,
                   help="HxW: profile only the train step at this size")
    args = p.parse_args(argv)
    on = {f if f.startswith("PANDORA_") else "PANDORA_" + f: True
          for f in args.flags.split(",") if f}
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
    if args.head_channels:
        cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
            cfg.unet, num_head_channels=args.head_channels))
    model = build_model(cfg, device=dev, dtype=torch.bfloat16,
                        generator=torch.Generator(device=dev)
                        .manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)
    img = torch.tensor(rng.integers(0, 256, (360, 640, 3), dtype=np.uint8),
                       device=dev).float() / 255.0
    tokenizer = load_clip_tokenizer()
    if args.train_hw:
        h, w = map(int, args.train_hw.split("x"))
        profile_train(cfg, model, dev, args, (h, w))
        return 0

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
        def unet_eval():
            return model.apply_model(x2, t2, ctx2, zc2, fs2)
        if args.head_channels:
            rec = profile_part("unet_eval", unet_eval, args.calls)
            rec["num_head_channels"] = args.head_channels
            print(json.dumps(rec), flush=True)
            return 0
        if on:
            # the same eval on a 72x128 latent (576x1024), the same context
            z_hi = torch.randn(*z.shape[:2], 576 // 8, 1024 // 8, z.shape[-1],
                               generator=gen, device=dev, dtype=model.dtype)
            x2_hi = torch.cat([z_hi, z_hi])

            def unet_eval_hi():
                return model.apply_model(x2_hi, t2, ctx2, x2_hi, fs2)
            for name, fn in (("unet_eval", unet_eval),
                             ("unet_eval_576x1024", unet_eval_hi)):
                for flagged in (False, True, True, False):
                    with flags.overridden(**(on if flagged else {})):
                        rec = profile_part(name + "+flags" * flagged, fn,
                                           args.calls)
                        rec["flags"] = flags.snapshot()
                    print(json.dumps(rec), flush=True)
            return 0
        parts = (
            ("unet_eval", unet_eval),
            ("decode", lambda: model.decode(z, frame_chunk=8)),
        )
        for name, fn in parts:
            print(json.dumps(profile_part(name, fn, args.calls)), flush=True)

    profile_train(cfg, model, dev, args, (cfg.train.height, cfg.train.width))
    del model
    torch.cuda.empty_cache()
    profile_world(cfg, dev, args)
    return 0


def profile_train(cfg: PandoraConfig, model, dev, args, hw) -> None:
    """One `dynamicrafter` finetune step at batch 1 on frames of size hw
    (part "train_step", with "_HxW" beyond the config's 320x512)."""
    tcfg = cfg.train
    state = TrainState.create(model, "dynamicrafter", tcfg)
    step = make_finetune_step(model, tcfg)
    rng = np.random.default_rng(args.seed)
    t, c = tcfg.video_length, cfg.clip_vision.image_size
    video = rng.uniform(-1, 1, (1, t, *hw, 3)).astype(np.float32)
    batch = {"video": video, "cond_frames": video[:, :1],
             "cond_images": rng.random((1, c, c, 3), np.float32),
             "text_tokens": np.asarray([load_clip_tokenizer()(
                 "synthetic clip 0", cfg.clip_text.context_length)]),
             "fps": np.asarray([8])}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    name = ("train_step" if tuple(hw) == (tcfg.height, tcfg.width)
            else "train_step_{}x{}".format(*hw))
    torch.cuda.reset_peak_memory_stats()
    rec = profile_part(name, lambda: step(state, batch, generator=gen),
                       args.calls)
    rec["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(json.dumps(rec), flush=True)
    if tuple(hw) != (tcfg.height, tcfg.width):
        print(json.dumps({"part": name, "peak_by_layer": peak_by_layer(
            model.model.diffusion_model,
            lambda: step(state, batch, generator=gen))}), flush=True)
    del state, step
    torch.cuda.empty_cache()


def peak_by_layer(unet, fn, top: int = 8) -> list:
    """Run fn (a training step) with `max_memory_allocated` read and reset
    at the entry of every layer of the UNet's blocks and at the start of
    the backward: [phase, the layer the interval starts at, the one it
    ends at, its peak in bytes] for the `top` highest intervals. In the
    backward a layer is entered when its checkpoint recomputes it, so an
    interval holds its first layer's recompute and gradient."""
    names = {id(m): n for n, m in unet.named_modules()}
    phase, last, readings = ["forward"], ["start"], []

    def read(tag):
        torch.cuda.synchronize()
        readings.append([phase[0], last[0], tag,
                         torch.cuda.max_memory_allocated()])
        torch.cuda.reset_peak_memory_stats()
        last[0] = tag

    hooks = [layer.register_forward_pre_hook(
        lambda m, args: read(names[id(m)]))
        for block in (*unet.input_blocks, unet.middle_block,
                      *unet.output_blocks) for layer in block]
    real_backward = torch.Tensor.backward

    def backward(self, *a, **kw):
        read("loss")
        phase[0] = "backward"
        return real_backward(self, *a, **kw)
    torch.Tensor.backward = backward
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        read("end")
    finally:
        torch.Tensor.backward = real_backward
        for h in hooks:
            h.remove()
    return sorted(readings, key=lambda r: -r[3])[:top]


def profile_world(cfg: PandoraConfig, dev, args) -> None:
    """The parts of one ChatWM round at 576x1024 on the full-width
    WorldModel."""
    from open_pandora_tpu_torch.models.world_model import (next_round_prompt,
                                                           round1_prompt)
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model

    wm = build_world_model(cfg, device=dev, dtype=torch.bfloat16,
                           generator=torch.Generator(device=dev)
                           .manual_seed(args.seed + 3))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    T, size = cfg.unet.temporal_length, cfg.clip_tower.image_size
    images = torch.randn(1, 1 + T, size, size, 3, generator=gen, device=dev)
    # texts of 9 and 5 tokens in ChatWM's 16-token bucket
    ids = torch.randint(3, 31000, (2, 1, 16), generator=gen, device=dev)
    masks = [torch.arange(16, device=dev)[None] < n for n in (9, 5)]
    round1 = round1_prompt(ids[0], images=images[:, :1], text_mask=masks[0])
    round2 = next_round_prompt(round1, range(1, 1 + T), ids[1],
                               text_mask=masks[1])
    round2.images = images
    hz, wz = 576 // 8, 1024 // 8
    with torch.no_grad():
        ctx = wm.get_diffusion_conditioning(round2)[:, -1]
        z = torch.randn(1, T, hz, wz, cfg.vae.z_channels, generator=gen,
                        device=dev, dtype=wm.dtype)
        x2, zc2 = torch.cat([z, z]), torch.cat([z, z])
        t2 = torch.full((2,), 999, dtype=torch.int64, device=dev)
        fs2 = torch.full((2,), 3, dtype=torch.int64, device=dev)
        img_ctx = torch.randn(1, T * cfg.unet.img_tokens_per_frame,
                              cfg.unet.context_dim, generator=gen, device=dev,
                              dtype=wm.dtype)
        ctx2 = torch.cat([torch.cat([ctx, img_ctx], dim=1)] * 2)
        parts = (
            ("conditioning_llm_round1",
             lambda: wm.get_diffusion_conditioning(round1)),
            ("conditioning_llm_round2",
             lambda: wm.get_diffusion_conditioning(round2)),
            ("unet_eval_576x1024",
             lambda: wm.diffusion.apply_model(x2, t2, ctx2, zc2, fs2)),
            ("decode_576x1024", lambda: wm.diffusion.decode(z, frame_chunk=2)),
        )
        for name, fn in parts:
            print(json.dumps(profile_part(name, fn, args.calls)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
