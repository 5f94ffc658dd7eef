#!/usr/bin/env python3
"""Drive the PyTorch port (open_pandora_tpu_torch) once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--ddim-steps 10]

Phases, each printing its own lines and raising on failure:
  1. env      torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds the kernel library from csrc/ (or loads it)
  3. kernels  each CUDA kernel against its plain PyTorch version at every
              shape of the slice's main path, plus causal, ragged and fp32
              cases; kernel and plain times from CUDA events
  4. model    a narrow DynamiCrafter at 320x512x16f in fp32: DDIM-2 on the
              card (kernels) against the same weights and noise on the CPU
              (plain versions)
  5. slice    the full-width PandoraConfig() in bf16 through
              eval.inference.synthesize; launch counts against the routing
The last two lines are the kernels' JSON summary and the run's JSON result.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

FLASH_SRC = "open_pandora_tpu_torch/csrc/flash_fwd.cu"
SMALL_SRC = "open_pandora_tpu_torch/csrc/small_attn_fwd.cu"
FLASH_TPU = "open_pandora_tpu/ops/flash_attention.py:92"
SMALL_TPU = "open_pandora_tpu/ops/small_attention.py:60"


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, *, warmup: int = 2, iters: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernels against their plain versions ---------------------------

def _kernel_bound(out, plain, ref32) -> tuple:
    """max|kernel - ref32| must stay within 2 max|plain - ref32| plus 1% of
    mean|ref32| (ref32: the plain version in fp32 on the same inputs)."""
    err = (out.float() - ref32).abs().max().item()
    plain_err = (plain.float() - ref32).abs().max().item()
    bound = 2 * plain_err + 1e-2 * ref32.abs().mean().item()
    return err, bound


def check_kernels(device, gen) -> dict:
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal); the first rows are the slice's shapes
    flash_cases = [
        (32, 2560, 2560, 5, 64, bf16, False),   # UNet attn1, 40x64 latent
        (32, 640, 640, 10, 64, bf16, False),    # UNet attn1, 20x32
        (1, 2560, 2560, 1, 512, bf16, False),   # VAE encoder mid-block
        (8, 2560, 2560, 1, 512, bf16, False),   # VAE decoder mid, per chunk
        (2, 1000, 1100, 4, 128, bf16, True),    # causal, N < M, ragged M
        (2, 1000, 1100, 4, 128, f32, True),
        (2, 700, 300, 3, 80, bf16, False),      # ragged both, D = 80
        (32, 2560, 2560, 2, 32, f32, False),    # narrow model (phase 4)
        (1, 2560, 2560, 1, 128, f32, False),    # narrow VAE mid (phase 4)
        (8, 2560, 2560, 1, 512, f32, False),
    ]
    small_cases = [
        (5120, 16, 16, 5, 64, bf16),   # temporal attn, 40x64 latent
        (5120, 16, 16, 8, 64, bf16),   # init_attn
        (1280, 16, 16, 10, 64, bf16),  # 20x32
        (320, 16, 16, 20, 64, bf16),   # 10x16
        (80, 16, 16, 20, 64, bf16),    # middle block 5x8
        (5120, 16, 16, 2, 32, f32),    # narrow model (phase 4)
        (5120, 16, 16, 8, 32, f32),
        (100, 7, 16, 3, 48, f32),      # ragged N < M
    ]
    summary = {}

    def run(name, kern, plain, cases, causal_arg):
        for case in cases:
            B, N, M, H, D, dt = case[:6]
            kw = {"causal": case[6]} if causal_arg else {}
            q = torch.randn(B, N, H, D, generator=gen, device=device).to(dt)
            k = torch.randn(B, M, H, D, generator=gen, device=device).to(dt)
            v = torch.randn(B, M, H, D, generator=gen, device=device).to(dt)
            out = kern(q, k, v, **kw)
            torch.cuda.synchronize()
            ref32 = plain(q.float(), k.float(), v.float(), **kw)
            ref_dt = plain(q, k, v, **kw)
            extra = {}
            if causal_arg:  # flash: (o, lse); the LSE is fp32 on both sides
                (out, lse), (ref32, lse32), ref_dt = out, ref32, ref_dt[0]
                extra["lse_max_abs_err"] = (lse - lse32).abs().max().item()
            err, bound = _kernel_bound(out, ref_dt, ref32)
            del ref32, ref_dt
            ms = cuda_ms(lambda: kern(q, k, v, **kw))
            plain_ms = cuda_ms(lambda: plain(q, k, v, **kw))
            # LSE: fp32 statistics of the same fp32 scores, summation order
            # only; 1e-3 is 1e-4 of its magnitude (about log M + max score)
            ok = bool(np.isfinite(err) and err <= bound
                      and extra.get("lse_max_abs_err", 0.0) <= 1e-3)
            log("kernels", json.dumps({
                "kernel": name, "shape": [B, N, H, D], "M": M,
                "dtype": str(dt).replace("torch.", ""), **kw,
                "max_abs_err": err, "bound": bound, **extra, "ms": ms,
                "plain_ms": plain_ms, "ok": ok}))
            if not ok:
                raise AssertionError(f"{name} {case}: max|err| {err} > {bound}"
                                     f" or {extra}")
            summary.setdefault(name, {"max_abs_err": err, "ms": ms,
                                      "plain_ms": plain_ms})
            del q, k, v, out
            torch.cuda.empty_cache()

    run("flash_fwd", functools.partial(flash_attention, return_lse=True),
        flash_attention_plain, flash_cases, True)
    run("small_attn_fwd", small_attention, small_attention_plain,
        [c[:6] for c in small_cases], False)
    return summary


# -- phase 4: narrow model, card against CPU ---------------------------------

def narrow_config():
    """Narrow widths, the full 4-level VAE (latent 40x64 at 320x512) and a
    2-level UNet with attention at both levels, so the 2560- and 640-token
    flash sites, the VAE mid-block flash site and the t = 16 small sites
    all run."""
    from open_pandora_tpu_torch.core import config as c
    return c.PandoraConfig(
        vae=c.VAEConfig(base_channels=32, num_res_blocks=1),
        unet=c.UNet3DConfig(model_channels=64, channel_mult=(1, 2),
                            num_res_blocks=1, attention_resolutions=(1, 2),
                            num_head_channels=32, context_dim=64,
                            dropout=0.0),
        clip_text=c.CLIPTextConfig(width=64, layers=2, heads=2),
        clip_vision=c.CLIPVisionConfig(width=64, layers=2, heads=2),
        resampler=c.ResamplerConfig(dim=64, depth=1, dim_head=16, heads=4,
                                    embedding_dim=64, output_dim=64))


BOUND_REL = 1e-4    # card against CPU, relative to the largest |value|


def check_model(device, seed: int) -> None:
    from open_pandora_tpu_torch.eval.inference import (build_model,
                                                       diffusion_preprocess)
    from open_pandora_tpu_torch.ops.flash_attention import flash_attention
    from open_pandora_tpu_torch.ops.small_attention import small_attention

    cfg = narrow_config()
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed)
    T, hz, wz = cfg.unet.temporal_length, 40, 64
    image = torch.from_numpy(rng.random((320, 512, 3), np.float32))
    ids = torch.from_numpy(rng.integers(1, 49000, (1, 77)))
    x_T = torch.from_numpy(rng.standard_normal((1, T, hz, wz, 4),
                                               np.float32))
    noise = [torch.from_numpy(rng.standard_normal((1, T, hz, wz, 4),
                                                  np.float32))
             for _ in range(2)]
    kw = dict(ddim_steps=2, guidance_scale=7.5, eta=1.0, fs=3,
              guidance_rescale=0.7, x_T=x_T, noise=noise)
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = model.device
        flash0, small0 = flash_attention.launches, small_attention.launches
        t0 = time.perf_counter()
        with torch.no_grad():
            z = model.image_guided_synthesis(
                text_context=model.encode_text(ids.to(dev)),
                cond_images=image[None].to(dev),
                cond_frames=diffusion_preprocess(image, (320, 512))[
                    None, None].to(dev), **kw)
            video = model.decode(z, frame_chunk=8)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (z.cpu(), video.cpu())
        n = (flash_attention.launches - flash0,
             small_attention.launches - small0)
        out.setdefault("launches", n)
        log("model", f"{name}: {time.perf_counter() - t0:.1f} s, flash "
            f"launches {n[0]}, small launches {n[1]}")
    launches = out.pop("launches")
    (zc, vc), (zr, vr) = out["card"], out["cpu"]
    z_err = (zc - zr).abs().max().item()
    v_err = (vc - vr).abs().max().item()
    z_scale = zr.abs().max().item()
    v_scale = max(1.0, vr.abs().max().item())
    # fp32 on both sides, TF32 off: the kernels, cuBLAS and cuDNN differ
    # from the CPU in summation order only. On an H100 the gap read 2.7e-5
    # on latents of scale 6.1 and 2.8e-5 on frames of scale 5.9 (about 5e-6
    # of the scale). Bound: 1e-4 of the scale, some 20 times that reading.
    ok = (bool(torch.isfinite(zc).all()) and z_err <= BOUND_REL * z_scale
          and v_err <= BOUND_REL * v_scale)
    log("model", json.dumps({
        "latents": list(zc.shape), "latents_max_abs_err": z_err,
        "latents_scale": z_scale, "frames_max_abs_err": v_err,
        "frames_scale": v_scale, "bound_rel": BOUND_REL, "ok": ok}))
    if not ok:
        raise AssertionError("card and CPU latents disagree")
    want = predicted_launches(cfg, 320, 512, 2, frame_chunk=8)
    if launches != (want["flash"], want["small"]):
        raise AssertionError(f"card launches {launches} != predicted {want}")


# -- phase 5: the slice at full width -----------------------------------------

def predicted_launches(cfg, height: int, width: int, steps: int,
                       frame_chunk: int) -> dict:
    """Kernel launches of one synthesize() call, derived from the model's
    structure and the dispatcher's routing (attention_route) on the shapes
    each attention sees. Batched CFG runs cond and uncond as batch 2."""
    from open_pandora_tpu_torch.ops.attention import attention_route

    def route(q, k):
        return attention_route(q, k, causal=False, masked=False,
                               on_device=True)

    u, v = cfg.unet, cfg.vae
    b, t, d = 2, u.temporal_length, u.num_head_channels
    hz, wz = height // 8, width // 8
    per_eval = []                       # routes of one UNet eval

    def temporal(ds, heads):            # attn1 and attn2 both self-attend
        q = (b * (hz // ds) * (wz // ds), t, heads, d)
        per_eval.extend([route(q, q)] * 2)

    def spatial(ds, ch):
        n, h = (hz // ds) * (wz // ds), ch // d
        q = (b * t, n, h, d)
        per_eval.extend([route(q, q),
                         route(q, (b * t, u.text_context_len, h, d)),
                         route(q, (b * t, u.img_tokens_per_frame, h, d))])

    if u.addition_attention:
        temporal(1, 8)
    ds = 1
    for level, mult in enumerate(u.channel_mult):
        ch = mult * u.model_channels
        if ds in u.attention_resolutions:
            for _ in range(u.num_res_blocks):
                spatial(ds, ch)
                temporal(ds, ch // d)
        if level != len(u.channel_mult) - 1:
            ds *= 2
    spatial(ds, ch)                     # middle block
    temporal(ds, ch // d)
    for level, mult in reversed(list(enumerate(u.channel_mult))):
        ch = mult * u.model_channels
        if ds in u.attention_resolutions:
            for _ in range(u.num_res_blocks + 1):
                spatial(ds, ch)
                temporal(ds, ch // d)
        if level:
            ds //= 2

    c_mid = v.base_channels * v.channel_mult[-1]
    vae = [route((1, hz * wz, 1, c_mid), (1, hz * wz, 1, c_mid))]   # encode
    q = (frame_chunk, hz * wz, 1, c_mid)
    vae += [route(q, q)] * (u.temporal_length // frame_chunk)       # decode
    counts = {"per_eval": {r: per_eval.count(r) for r in
                           ("flash", "small")}}
    for r in ("flash", "small"):
        counts[r] = steps * counts["per_eval"][r] + vae.count(r)
    return counts


def run_slice(device, seed: int, steps: int) -> dict:
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.eval.inference import build_model, synthesize
    from open_pandora_tpu_torch.ops.flash_attention import flash_attention
    from open_pandora_tpu_torch.ops.small_attention import small_attention

    cfg = PandoraConfig()
    t0 = time.perf_counter()
    model = build_model(cfg, device=device, dtype=torch.bfloat16,
                        generator=torch.Generator(device=device)
                        .manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log("slice", f"PandoraConfig() bf16, {n_params} parameters, built in "
        f"{time.perf_counter() - t0:.1f} s")
    image = np.random.default_rng(seed).integers(0, 256, (360, 640, 3),
                                                 dtype=np.uint8)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    small_attention.launches = 0
    frames = synthesize(model, image, "a red car drives along a coastal "
                        "road at sunset", height=320, width=512,
                        ddim_steps=steps, guidance_scale=7.5,
                        guidance_rescale=0.7, eta=1.0, fs=3, generator=gen,
                        timings=timings)
    launches = {"flash": flash_attention.launches,
                "small": small_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    log("slice", json.dumps({
        "frames": list(frames.shape), "finite": bool(np.isfinite(frames)
                                                     .all()),
        "min": float(frames.min()), "max": float(frames.max()),
        "std": float(frames.std()), "ddim_steps": steps, **timings,
        "max_memory_allocated": peak, "launches": launches}))
    if frames.shape != (1, 16, 320, 512, 3) or not np.isfinite(frames).all():
        raise AssertionError(f"bad clip: {frames.shape}")
    if float(frames.std()) == 0.0:
        raise AssertionError("constant clip")
    # 8-frame decode chunks at 320x512 (eval/inference.synthesize)
    want = predicted_launches(cfg, 320, 512, steps, frame_chunk=8)
    log("slice", f"predicted launches: {json.dumps(want)}")
    # PandoraConfig(): per UNet eval 10 flash (attn1 at 2560 and 640 tokens:
    # 4 input + 6 output blocks) and 34 small (17 temporal transformers x
    # attn1 and attn2); plus 1 flash for the VAE encode, 1 per decode chunk
    assert want["per_eval"]["flash"] == 10 and want["per_eval"]["small"] == 34
    if launches["flash"] != want["flash"] or launches["small"] != want["small"]:
        raise AssertionError(f"launches {launches} != predicted {want}")
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return launches


def main(argv=None) -> int:
    p = argparse.ArgumentParser("chip_smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ddim-steps", type=int, default=10)
    args = p.parse_args(argv)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's card run "
                         "needs one")
    from open_pandora_tpu_torch.ops import kernels

    device = torch.device("cuda")
    # the fp32 phases compare against fp32 references: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log("env", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}; tf32 off for matmul and cudnn")
    log("env", f"nvidia-smi: {card}")

    t0 = time.perf_counter()
    kernels.library()
    log("build", f"{kernels.library_path().name} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    log_path = kernels.library_path().with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("build", line.strip())

    gen = torch.Generator(device=device).manual_seed(args.seed)
    summary = check_kernels(device, gen)
    check_model(device, args.seed)
    launches = run_slice(device, args.seed, args.ddim_steps)

    kernels_line = {"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_TPU, "launches": launches["flash"],
         **summary["flash_fwd"]},
        {"name": "small_attn_fwd", "route": "cuda", "source": SMALL_SRC,
         "replaces": SMALL_TPU, "launches": launches["small"],
         **summary["small_attn_fwd"]},
    ]}
    print(card, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
