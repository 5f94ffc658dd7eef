"""Time the CFG-pair UNet eval, the DDIM loop's body, at the product shape.

Counterpart of open_pandora_tpu/tools/profile_unet.py: the batched-CFG
UNet eval (cond and uncond as batch 2) at 320x512 with random bf16
weights (core/init.init_random_ on the device), the calls chained through
their outputs and timed with CUDA events (host clock and synchronize on
the CPU). With --profile, two calls run under utils/profiling.trace and
the kernel time per call is printed by class (eval/profile_step
.kernel_class).

A/B the routes with the env gates of core/flags.py, read at each call:
    PANDORA_DISABLE_PACKED=1   packed-layout attention off
    PANDORA_DISABLE_DUALCA=1   head-split dual cross-attention off
    PANDORA_DISABLE_FUSED=1    the whole fused route off

Usage: python -m open_pandora_tpu_torch.tools.profile_unet [--iters 10]
       [--profile] [--label NAME] [--height 320 --width 512] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch

from open_pandora_tpu_torch.core.config import PandoraConfig


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_ms(fn, iters: int, device: torch.device) -> float:
    """ms per call of `iters` calls: CUDA events on a card, the host
    clock around synchronize elsewhere."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def cfg_eval(cfg: PandoraConfig, device, *, height: int, width: int,
             dtype=torch.bfloat16, seed: int = 0):
    """(unet, step): a UNet with random weights and `step(x) -> x'`, one
    CFG-pair eval on inputs made from `seed` (x, the context and the
    conditioning latents of batch 2, t = 500, fs = 15)."""
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.unet3d import UNetModel

    device = torch.device(device)
    with torch.device("meta"):
        unet = UNetModel(cfg.unet)
    unet = unet.to(dtype=dtype).to_empty(device=device).eval()
    gen = torch.Generator(device=device).manual_seed(seed)
    init_random_(unet, gen)
    u = cfg.unet
    t, hz, wz, b = u.temporal_length, height // 8, width // 8, 2
    ctx_len = u.text_context_len + t * u.img_tokens_per_frame

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)

    x, ctx, zc = (rnd(b, t, hz, wz, 4), rnd(b, ctx_len, u.context_dim),
                  rnd(b, t, hz, wz, 4))
    ts = torch.full((b,), 500, dtype=torch.int64, device=device)
    fs = torch.full((b,), 15, dtype=torch.int64, device=device)

    @torch.no_grad()
    def step(xx):
        return unet(torch.cat([xx, zc], dim=-1), ts, ctx, fs=fs)

    return unet, step, x


def class_ms(prof, calls: int) -> dict:
    """Kernel ms per call by eval/profile_step.kernel_class."""
    from torch.autograd import DeviceType

    from open_pandora_tpu_torch.eval.profile_step import kernel_class

    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        cls = kernel_class(e.key)
        out[cls] = out.get(cls, 0.0) + e.self_device_time_total / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile_unet(cfg: PandoraConfig, device, *, height: int = 320,
                 width: int = 512, iters: int = 10, profile: bool = False,
                 label: str = "unet", dtype=torch.bfloat16) -> dict:
    """The CFG-pair eval's first call (s) and ms per call over `iters`
    chained calls; with `profile`, kernel ms per call by class."""
    from open_pandora_tpu_torch.utils.profiling import trace

    device = torch.device(device)
    unet, step, x = cfg_eval(cfg, device, height=height, width=width,
                             dtype=dtype)
    sync(device)
    t0 = time.perf_counter()
    y = step(x)
    sync(device)
    first = time.perf_counter() - t0
    print(f"first call: {first:.1f}s", flush=True)
    state = {"y": x}

    def chained():
        state["y"] = step(state["y"])

    per = timed_ms(chained, iters, device)
    print(f"EVAL {label} {per:.1f} ms/CFG-pair", flush=True)
    rep = {"label": label, "first_call_s": first, "ms_per_cfg_eval": per,
           "iters": iters, "shape": list(y.shape), "device": str(device),
           "finite": bool(torch.isfinite(state["y"]).all())}
    if profile:
        logdir = tempfile.mkdtemp(prefix=f"profile_{label}_")
        with trace(logdir) as prof:
            for _ in range(2):
                chained()
            sync(device)
        rep["by_class_ms"] = class_ms(prof, 2)
        for cls, ms in rep["by_class_ms"].items():
            print(f"  {cls:20s} {ms:8.2f} ms", flush=True)
        print("trace logdir:", logdir, flush=True)
    del unet
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("profile-unet")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--label", default="unet")
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    profile_unet(PandoraConfig(), args.device, height=args.height,
                 width=args.width, iters=args.iters, profile=args.profile,
                 label=args.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
