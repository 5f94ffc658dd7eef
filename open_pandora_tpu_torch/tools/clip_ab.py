"""Clip-level A/B harness: the DDIM loop where the product runs it, beside
the isolated eval that tools/profile_unet.py times.

Counterpart of open_pandora_tpu/tools/clip_ab.py, in three measurements:

  1. the isolated chained CFG-pair eval (profile_unet's)
  2. eval.inference.synthesize at --steps-a and --steps-b DDIM steps: the
     slope (tB - tA) / (B - A) is the marginal cost of a DDIM step inside
     the clip, free of the one-time conditioning and decode; with it the
     one-time part and the projected DDIM-50 clip
  3. with --profile, a trace of the steps-a clip, kernel ms by class

The port reads its route flags at each call (core/flags.py), so an A/B of
routes may run in one process, each side under core.flags.overridden, as
well as in two processes with the env gates (PANDORA_DISABLE_PACKED,
PANDORA_DISABLE_DUALCA, PANDORA_DISABLE_FUSED).

Usage: python -m open_pandora_tpu_torch.tools.clip_ab [--steps-a 5
       --steps-b 25] [--iters 10] [--height 320 --width 512] [--profile]
       [--label NAME] [--skip-eval] [--guidance-scale 4.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from open_pandora_tpu_torch.core.config import PandoraConfig
from open_pandora_tpu_torch.tools.profile_unet import (class_ms,
                                                       profile_unet, sync)


def clip_ab(cfg: PandoraConfig, device, *, steps_a: int = 5,
            steps_b: int = 25, iters: int = 10, height: int = 320,
            width: int = 512, profile: bool = False, label: str = "clip",
            skip_eval: bool = False, guidance_scale: float = 4.0,
            n_timed: int = 2, dtype=torch.bfloat16) -> dict:
    """The three measurements; returns their numbers (s and ms)."""
    from open_pandora_tpu_torch.eval.inference import (build_model,
                                                       synthesize)
    from open_pandora_tpu_torch.pipeline.tokenizers import \
        load_clip_tokenizer
    from open_pandora_tpu_torch.utils.profiling import trace

    device = torch.device(device)
    rep = {"label": label, "device": str(device)}
    if not skip_eval:
        rep["eval"] = profile_unet(cfg, device, height=height, width=width,
                                   iters=iters, label=label, dtype=dtype)
    model = build_model(cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device)
                        .manual_seed(0))
    image = np.full((height, width, 3), 0.5, np.float32)
    tok = load_clip_tokenizer()

    def clip(steps, seed):
        return synthesize(model, image, "a car drives along the road",
                          height=height, width=width, ddim_steps=steps,
                          guidance_scale=guidance_scale, eta=1.0, fs=15,
                          tokenizer=tok, generator=torch.Generator(
                              device=device).manual_seed(seed))

    def run(steps):
        sync(device)
        t0 = time.perf_counter()
        clip(steps, 7)
        sync(device)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(n_timed):
            video = clip(steps, 8 + i)
        sync(device)
        warm = (time.perf_counter() - t0) / n_timed
        print(f"[{label}] synth ddim{steps}: warm {warm:.3f}s "
              f"(first {first:.1f}s)", flush=True)
        return warm, video

    t_a, video = run(steps_a)
    t_b, _ = run(steps_b)
    slope = (t_b - t_a) / (steps_b - steps_a)
    const = t_a - slope * steps_a
    print(f"[{label}] IN-CLIP slope: {slope * 1e3:.1f} ms/step "
          f"(one-time overhead {const:.3f}s; "
          f"ddim50 projection {const + 50 * slope:.2f}s)", flush=True)
    rep.update(steps_a=steps_a, steps_b=steps_b, clip_a_s=t_a, clip_b_s=t_b,
               slope_ms_per_step=slope * 1e3, one_time_s=const,
               ddim50_projection_s=const + 50 * slope,
               finite=bool(np.isfinite(video).all()))
    if profile:
        logdir = tempfile.mkdtemp(prefix=f"profile_clip_{label}_")
        with trace(logdir) as prof:
            clip(steps_a, 99)
            sync(device)
        rep["by_class_ms"] = class_ms(prof, 1)
        for cls, ms in rep["by_class_ms"].items():
            print(f"  {cls:20s} {ms:9.2f} ms", flush=True)
        print("trace logdir:", logdir, flush=True)
    del model
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("clip-ab")
    ap.add_argument("--steps-a", type=int, default=5)
    ap.add_argument("--steps-b", type=int, default=25)
    ap.add_argument("--iters", type=int, default=10,
                    help="isolated-eval iters")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--profile", action="store_true",
                    help="trace the steps-a clip")
    ap.add_argument("--label", default="clip")
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--guidance-scale", type=float, default=4.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    clip_ab(PandoraConfig(), args.device, steps_a=args.steps_a,
            steps_b=args.steps_b, iters=args.iters, height=args.height,
            width=args.width, profile=args.profile, label=args.label,
            skip_eval=args.skip_eval, guidance_scale=args.guidance_scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
