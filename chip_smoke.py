#!/usr/bin/env python3
"""Drive the PyTorch port (open_pandora_tpu_torch) once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--ddim-steps 10]

Phases, each printing its own lines and raising on failure:
  1. env      torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds the kernel library from csrc/ (or loads it)
  3. kernels  each CUDA kernel against its plain PyTorch version at every
              shape of the slice's main path, plus ragged cases (and fp32
              ones for the two kernels that take fp32);
              kernel and plain times from CUDA events
  4. model    a narrow DynamiCrafter at 320x512x16f: in fp32, DDIM-2 on the
              card (unfused route) against the same weights and noise on
              the CPU; in bf16, one CFG UNet eval and one 8-frame decode
              chunk on the card (the fused route) and on the CPU (the
              unfused route), both against fp32 on the CPU
  5. slice    the full-width PandoraConfig() in bf16 through
              eval.inference.synthesize (the fused route); launch counts
              against the routing
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

CSRC = "open_pandora_tpu_torch/csrc/"
# name -> (launch-count key, source, the Pallas kernel it replaces)
KERNELS = {
    "flash_fwd": ("flash", CSRC + "flash_fwd.cu",
                  "open_pandora_tpu/ops/flash_attention.py:92"),
    "small_attn_fwd": ("small", CSRC + "small_attn_fwd.cu",
                       "open_pandora_tpu/ops/small_attention.py:60"),
    "packed_attn_fwd": ("packed", CSRC + "packed_attn_fwd.cu",
                        "open_pandora_tpu/ops/packed_attention.py:104"),
    "fused_temporal_attn": ("fused_temporal", CSRC + "fused_temporal_attn.cu",
                            "open_pandora_tpu/ops/fused_temporal.py:33"),
    "group_norm_silu": ("group_norm", CSRC + "group_norm_silu.cu",
                        "open_pandora_tpu/ops/fused_norms.py:58"),
}
KERNEL_KEYS = tuple(key for key, _, _ in KERNELS.values())


def wrappers() -> dict:
    """The kernel wrappers by launch-count key; each counts its launches."""
    from open_pandora_tpu_torch.ops.flash_attention import flash_attention
    from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_self_attention)
    from open_pandora_tpu_torch.ops.packed_attention import packed_attention
    from open_pandora_tpu_torch.ops.small_attention import small_attention
    return {"flash": flash_attention, "small": small_attention,
            "packed": packed_attention,
            "fused_temporal": fused_temporal_self_attention,
            "group_norm": fused_group_norm_silu}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {key: fn.launches for key, fn in wrappers().items()}


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


def _check(summary: dict, name: str, case: dict, kern, plain, ref32_fn
           ) -> None:
    """Hold kern() to the bound against ref32_fn() (the plain version in
    fp32) with plain() (the plain version in the working dtype) setting
    the bound; time kern and plain."""
    out = kern()
    torch.cuda.synchronize()
    ref32 = ref32_fn()
    err, bound = _kernel_bound(out, plain(), ref32)
    del out, ref32
    ms = cuda_ms(kern)
    plain_ms = cuda_ms(plain)
    ok = bool(np.isfinite(err) and err <= bound)
    log("kernels", json.dumps({"kernel": name, **case, "max_abs_err": err,
                               "bound": bound, "ms": ms,
                               "plain_ms": plain_ms, "ok": ok}))
    if not ok:
        raise AssertionError(f"{name} {case}: max|err| {err} > {bound}")
    summary.setdefault(name, {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms})
    torch.cuda.empty_cache()


def check_kernels(device, gen) -> dict:
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal); the first rows are the slice's shapes
    flash_cases = [
        (1, 2560, 2560, 1, 512, bf16, False),   # VAE encoder mid-block
        (8, 2560, 2560, 1, 512, bf16, False),   # VAE decoder mid, per chunk
        (32, 2560, 2560, 5, 64, bf16, False),   # UNet attn1, unfused route
        (32, 640, 640, 10, 64, bf16, False),    # UNet attn1, 20x32
        (2, 1000, 1100, 4, 128, bf16, True),    # causal, N < M, ragged M
        (2, 1000, 1100, 4, 128, f32, True),
        (2, 700, 300, 3, 80, bf16, False),      # ragged both, D = 80
        (32, 2560, 2560, 2, 32, f32, False),    # narrow model (phase 4)
        (1, 2560, 2560, 1, 128, f32, False),    # narrow VAE mid (phase 4)
        (8, 2560, 2560, 1, 512, f32, False),
    ]
    small_cases = [
        (320, 16, 16, 20, 64, bf16),   # 1280-channel temporal, 10x16
        (80, 16, 16, 20, 64, bf16),    # middle block 5x8
        (5120, 16, 16, 5, 64, bf16),   # temporal attn, 40x64, unfused route
        (5120, 16, 16, 8, 64, bf16),   # init_attn, unfused route
        (1280, 16, 16, 10, 64, bf16),  # 20x32, unfused route
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
    check_packed(summary, device, gen)
    check_fused_temporal(summary, device, gen)
    check_group_norm(summary, device, gen)
    return summary


def check_packed(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_plain)

    bf16 = torch.bfloat16
    # (B, N, H, D, key rows per stream, gate, dtype); attn1 and attn2 of
    # the 2560- and 640-token spatial transformers, then ragged cases
    cases = [
        (32, 2560, 5, 64, (2560,), 1.0, bf16),
        (32, 640, 10, 64, (640,), 1.0, bf16),
        (32, 2560, 5, 64, (77, 16), 1.0, bf16),
        (32, 2560, 5, 64, (77, 16), 1.37, bf16),
        (32, 640, 10, 64, (77, 16), 1.0, bf16),
        (32, 640, 10, 64, (77, 16), 0.6, bf16),
        (32, 2560, 2, 32, (2560,), 1.0, bf16),   # narrow model (phase 4)
        (32, 640, 4, 32, (77, 16), 1.0, bf16),
        (2, 1000, 2, 128, (300,), 1.0, bf16),    # M not a tile multiple
        (2, 1000, 2, 128, (100, 130), 0.25, bf16),
    ]
    for B, N, H, D, ms, gate, dt in cases:
        hd = H * D

        def rnd(rows):
            return torch.randn(B, rows, hd, generator=gen,
                               device=device).to(dt)
        q = rnd(N)
        streams = [(rnd(m), rnd(m)) for m in ms]
        # the gate as the model hands it: a float, or a tensor when learnable
        g = gate if gate == 1.0 else torch.tensor(gate, device=device)
        _check(summary, "packed_attn_fwd",
               {"shape": [B, N, H, D], "M": list(ms), "gate": gate,
                "dtype": str(dt).replace("torch.", "")},
               lambda: packed_attention(q, streams, g, heads=H),
               lambda: packed_attention_plain(q, streams, g, heads=H),
               lambda: packed_attention_plain(
                   q.float(), [(k.float(), v.float()) for k, v in streams],
                   g, heads=H))
        del q, streams


def check_fused_temporal(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_plain, fused_temporal_self_attention)

    # (b, t, hw, c, heads): the level-0 and level-1 temporal transformers
    # and init_attn at 320x512, the narrow model's sites, then a ragged
    # position tile (74 positions, not a multiple of 4) and a 3-D stream
    cases = [
        ((2, 16, 2560, 320), 5),
        ((2, 16, 2560, 512), 8),
        ((2, 16, 640, 640), 10),
        ((2, 16, 2560, 64), 2),
        ((2, 16, 2560, 256), 8),
        ((2, 16, 640, 128), 4),
        ((2, 16, 37, 320), 5),
        ((100, 16, 640), 10),
    ]
    for shape, heads in cases:
        y, params = fused_temporal_inputs(shape, gen, device)
        _check(summary, "fused_temporal_attn",
               {"shape": list(shape), "heads": heads, "dtype": "bfloat16"},
               lambda: fused_temporal_self_attention(y, *params, heads=heads),
               lambda: fused_temporal_plain(y, *params, heads=heads),
               lambda: fused_temporal_plain(
                   y.float(), *[p.float() for p in params], heads=heads))
        del y, params


def fused_temporal_inputs(shape, gen, device) -> tuple:
    """bf16 y of the given shape and (wq, wk, wv, wo, bo, ln_w, ln_b) for
    c = shape[-1]: unit-scale activations, Xavier-scale projections, LN gain
    about 1, and the out-projection bias and the LN shift at unit scale, so
    the attention branch, its bias and its shift each move the output by
    far more than the bf16 rounding of the residual."""
    c = shape[-1]

    def rnd(*s, scale=1.0, shift=0.0):
        return (torch.randn(*s, generator=gen, device=device) * scale
                + shift).to(torch.bfloat16)
    params = ([rnd(c, c, scale=c ** -0.5) for _ in range(4)]
              + [rnd(c), rnd(c, scale=0.1, shift=1.0), rnd(c)])
    return rnd(*shape), params


def check_group_norm(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
    from open_pandora_tpu_torch.ops.norms import group_norm

    # (shape, eps, silu): the UNet's GroupNorm sites at 320x512 (ResBlocks
    # per level, temporal conv blocks, decoder concats, transformer
    # pre-norms), the VAE's, then a ragged slab. Four slabs exceed the JAX
    # resident kernel's 3 * 2**19 elements per sample.
    cases = [
        ((32, 40, 64, 320), 1e-5, True),        # ResBlock, level 0
        ((32, 20, 32, 640), 1e-5, True),
        ((32, 10, 16, 1280), 1e-5, True),
        ((32, 5, 8, 1280), 1e-5, True),
        ((2, 16, 40, 64, 320), 1e-5, True),     # temporal conv, 13.1M / sample
        ((2, 16, 20, 32, 640), 1e-5, True),
        ((32, 40, 64, 640), 1e-5, True),        # decoder concat, level 0
        ((32, 40, 64, 960), 1e-5, True),
        ((32, 10, 16, 2560), 1e-5, True),       # decoder concat, level 2
        ((32, 5, 8, 2560), 1e-5, True),         # decoder concat, level 3
        ((32, 40, 64, 320), 1e-6, False),       # spatial transformer norm
        ((2, 16, 40, 64, 320), 1e-6, False),    # temporal transformer norm
        ((8, 320, 512, 128), 1e-6, True),       # VAE decode, 21M / sample
        ((8, 320, 512, 256), 1e-6, True),
        ((8, 40, 64, 512), 1e-6, False),        # VAE mid attention norm
        ((1, 320, 512, 128), 1e-6, True),       # VAE encode
        ((3, 1000, 96), 1e-5, True),            # ragged splits, 3 ch/group
    ]
    for shape, eps, silu in cases:
        c = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=device) * 3.0
             + 0.5).to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
             ).to(torch.bfloat16)
        b = (0.05 * torch.randn(c, generator=gen, device=device)
             ).to(torch.bfloat16)
        kw = dict(num_groups=32, eps=eps, silu=silu)
        _check(summary, "group_norm_silu",
               {"shape": list(shape), "eps": eps, "silu": silu,
                "dtype": "bfloat16"},
               lambda: fused_group_norm_silu(x, w, b, **kw),
               lambda: group_norm(x, w, b, **kw),
               lambda: group_norm(x.float(), w.float(), b.float(), **kw))
        del x, w, b


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


def _narrow_inputs(cfg, seed: int):
    rng = np.random.default_rng(seed)
    T, hz, wz = cfg.unet.temporal_length, 40, 64
    image = torch.from_numpy(rng.random((320, 512, 3), np.float32))
    ids = torch.from_numpy(rng.integers(1, 49000, (1, 77)))
    x_T = torch.from_numpy(rng.standard_normal((1, T, hz, wz, 4),
                                               np.float32))
    noise = [torch.from_numpy(rng.standard_normal((1, T, hz, wz, 4),
                                                  np.float32))
             for _ in range(2)]
    return image, ids, x_T, noise


def check_model(device, seed: int) -> None:
    """fp32: DDIM-2 on the card (the unfused route) against the CPU."""
    from open_pandora_tpu_torch.eval.inference import (build_model,
                                                       diffusion_preprocess)

    cfg = narrow_config()
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed))
    card = copy.deepcopy(cpu).to(device)
    image, ids, x_T, noise = _narrow_inputs(cfg, seed)
    kw = dict(ddim_steps=2, guidance_scale=7.5, eta=1.0, fs=3,
              guidance_rescale=0.7, x_T=x_T, noise=noise)
    out = {}
    for name, model in (("card", card), ("cpu", cpu)):
        dev = model.device
        reset_launches()
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
        out.setdefault("launches", read_launches())
        log("model", f"fp32 {name}: {time.perf_counter() - t0:.1f} s, "
            f"launches {json.dumps(read_launches())}")
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
        "dtype": "float32", "latents": list(zc.shape),
        "latents_max_abs_err": z_err, "latents_scale": z_scale,
        "frames_max_abs_err": v_err, "frames_scale": v_scale,
        "bound_rel": BOUND_REL, "ok": ok}))
    if not ok:
        raise AssertionError("card and CPU latents disagree")
    # fp32 never takes the fused route: no GroupNorm, packed or fused
    # temporal launch
    want = predicted_launches(cfg, 320, 512, 2, frame_chunk=8, fused=False)
    if launches != {k: want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"card launches {launches} != predicted {want}")


def check_model_bf16(device, seed: int) -> None:
    """bf16: one CFG UNet eval and one 8-frame decode chunk on the card (the
    fused route) and on the CPU (the unfused route), each against fp32 on
    the CPU with the same bf16-rounded weights and inputs. The card passes
    where its error is within twice the CPU bf16 route's plus 1% of the
    mean |fp32 value| (the JAX package's fused_selfcheck rule,
    ops/fused_temporal.py:189-238, applied to the model)."""
    from open_pandora_tpu_torch.eval.inference import build_model

    cfg = narrow_config()
    u = cfg.unet
    cpu16 = build_model(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(seed + 2))
    ref32 = copy.deepcopy(cpu16).float()
    card16 = copy.deepcopy(cpu16).to(device)
    rng = np.random.default_rng(seed + 3)
    T, hz, wz = u.temporal_length, 40, 64

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)
                                ).bfloat16()
    x = arr(2, T, hz, wz, u.in_channels)
    ctx = arr(2, u.text_context_len + T * u.img_tokens_per_frame,
              u.context_dim)
    steps = torch.tensor([600, 600])
    fs = torch.tensor([3, 3])
    z = arr(1, 8, hz, wz, cfg.vae.z_channels)

    def run(model):
        dev, dt = model.device, model.dtype
        with torch.no_grad():
            eps = model.model.diffusion_model(x.to(dev, dt), steps.to(dev),
                                              ctx.to(dev, dt),
                                              fs=fs.to(dev))
            frames = model.decode(z.to(dev, dt), frame_chunk=8)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return eps.float().cpu(), frames.float().cpu()

    got = {}
    for name, model in (("card", card16), ("cpu_bf16", cpu16),
                        ("cpu_fp32", ref32)):
        reset_launches()
        t0 = time.perf_counter()
        got[name] = run(model)
        got.setdefault("launches", read_launches())
        log("model", f"bf16 leg {name}: {time.perf_counter() - t0:.1f} s")
    launches = got.pop("launches")
    report, ok = {"dtype": "bfloat16"}, True
    for i, part in enumerate(("unet_eval", "decode_chunk")):
        ref = got["cpu_fp32"][i]
        card_err = (got["card"][i] - ref).abs().max().item()
        cpu_err = (got["cpu_bf16"][i] - ref).abs().max().item()
        scale = ref.abs().mean().item()
        bound = 2 * cpu_err + 1e-2 * scale
        fine = bool(torch.isfinite(got["card"][i]).all()) and \
            card_err <= bound
        report[part] = {"card_max_abs_err": card_err,
                        "cpu_bf16_max_abs_err": cpu_err,
                        "mean_abs_fp32": scale, "bound": bound, "ok": fine}
        ok = ok and fine
    want = predicted_launches(cfg, 320, 512, 1, frame_chunk=8, fused=True)
    want = {k: want["per_eval"][k] + want["decode_chunk"][k]
            for k in KERNEL_KEYS}
    report["launches"], report["predicted"] = launches, want
    log("model", json.dumps(report))
    if not ok:
        raise AssertionError("bf16 card route disagrees with fp32 beyond "
                             "the bound")
    if launches != want or min(launches[k] for k in
                               ("packed", "fused_temporal", "group_norm")) <= 0:
        raise AssertionError(f"bf16 card launches {launches} != {want}")


# -- phase 5: the slice at full width -----------------------------------------

def predicted_launches(cfg, height: int, width: int, steps: int,
                       frame_chunk: int, fused: bool) -> dict:
    """Kernel launches of one synthesize() call, derived from the model's
    structure and the port's gates on the shapes each site sees: the
    dispatcher's routes (attention_route), and on the fused route (bf16
    eval on a CUDA device) the packed, fused temporal and GroupNorm gates.
    Batched CFG runs cond and uncond as batch 2. Returns the counts per
    UNet eval ("per_eval"), per VAE encode and decode chunk, and for the
    clip (one key per kernel)."""
    from open_pandora_tpu_torch.ops.attention import attention_route
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_eligible)
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention_eligible)

    def route(q, k):
        return attention_route(q, k, causal=False, masked=False,
                               on_device=True)

    u, v = cfg.unet, cfg.vae
    b, t, d = 2, u.temporal_length, u.num_head_channels
    depth = u.transformer_depth
    hz, wz = height // 8, width // 8
    per_eval = []                       # launches of one UNet eval

    def gn(ch, n=1):
        if fused and ch % 32 == 0:
            per_eval.extend(["group_norm"] * n)

    def temporal(ds, ch, heads):        # attn1 and attn2 both self-attend
        inner = heads * d
        gn(ch)
        for _ in range(depth):
            if (fused and not u.use_causal_attention
                    and fused_temporal_eligible(t, inner, inner)):
                per_eval.extend(["fused_temporal"] * 2)
            else:
                q = (b * (hz // ds) * (wz // ds), t, heads, d)
                per_eval.extend([route(q, q)] * 2)

    def spatial(ds, ch):
        n, h = (hz // ds) * (wz // ds), ch // d
        q = (b * t, n, h, d)
        ms = ((u.text_context_len, u.img_tokens_per_frame)
              if u.image_cross_attention else (u.text_context_len,))
        gn(ch)
        for _ in range(depth):
            if fused and packed_attention_eligible(n, (n,), h, h * d):
                per_eval.append("packed")
            else:
                per_eval.append(route(q, q))
            if fused and packed_attention_eligible(n, ms, h, h * d):
                per_eval.append("packed")
            else:
                per_eval.extend(route(q, (b * t, m, h, d)) for m in ms)

    def res(c_in, c_out):
        gn(c_in)
        gn(c_out, 1 + 4 * u.temporal_conv)

    mc = u.model_channels
    if u.addition_attention:
        temporal(1, mc, 8)
    chans, ch, ds = [mc], mc, 1
    for level, mult in enumerate(u.channel_mult):
        for _ in range(u.num_res_blocks):
            res(ch, mult * mc)
            ch = mult * mc
            if ds in u.attention_resolutions:
                spatial(ds, ch)
                if u.temporal_attention:
                    temporal(ds, ch, ch // d)
            chans.append(ch)
        if level != len(u.channel_mult) - 1:
            chans.append(ch)
            ds *= 2
    res(ch, ch)                         # middle block
    spatial(ds, ch)
    if u.temporal_attention:
        temporal(ds, ch, ch // d)
    res(ch, ch)
    for level, mult in reversed(list(enumerate(u.channel_mult))):
        for i in range(u.num_res_blocks + 1):
            res(ch + chans.pop(), mult * mc)
            ch = mult * mc
            if ds in u.attention_resolutions:
                spatial(ds, ch)
                if u.temporal_attention:
                    temporal(ds, ch, ch // d)
            if level and i == u.num_res_blocks:
                ds //= 2
    gn(ch)                              # out

    # VAE: per encode and per decode chunk, the ResnetBlocks' two norms,
    # the mid block (two ResnetBlocks and the attention norm), norm_out;
    # the mid-block attention is one head of width C
    c_mid = v.base_channels * v.channel_mult[-1]
    levels, nrb = len(v.channel_mult), v.num_res_blocks
    gn_on = fused and v.base_channels % 32 == 0

    def vae_part(n_blocks, batch):
        q = (batch, hz * wz, 1, c_mid)
        counts = dict.fromkeys(KERNEL_KEYS, 0)
        r = route(q, q)
        if r in counts:
            counts[r] += 1
        counts["group_norm"] = gn_on * (2 * n_blocks + 2 * 2 + 1 + 1)
        return counts

    def tally(seq):
        return {k: seq.count(k) for k in KERNEL_KEYS}

    encode = vae_part(levels * nrb, 1)
    chunk = vae_part(levels * (nrb + 1), frame_chunk)
    chunks = u.temporal_length // frame_chunk
    counts = {"per_eval": tally(per_eval), "encode": encode,
              "decode_chunk": chunk}
    for k in KERNEL_KEYS:
        counts[k] = (steps * counts["per_eval"][k] + encode[k]
                     + chunks * chunk[k])
    return counts


def run_slice(device, seed: int, steps: int) -> dict:
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.eval.inference import build_model, synthesize

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
    reset_launches()
    frames = synthesize(model, image, "a red car drives along a coastal "
                        "road at sunset", height=320, width=512,
                        ddim_steps=steps, guidance_scale=7.5,
                        guidance_rescale=0.7, eta=1.0, fs=3, generator=gen,
                        timings=timings)
    launches = read_launches()
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
    want = predicted_launches(cfg, 320, 512, steps, frame_chunk=8,
                              fused=True)
    log("slice", f"predicted launches: {json.dumps(want)}")
    # PandoraConfig(), per UNet eval: 20 packed (attn1 and attn2 of the ten
    # spatial transformers at 2560 and 640 tokens), 22 fused temporal
    # (init_attn and the ten 320/640-channel temporal transformers, attn1
    # and attn2), 12 small (the six 1280-channel temporal transformers), no
    # flash, 166 GroupNorm (44 ResBlock, 88 temporal conv, 16 spatial, 17
    # temporal, 1 out); per clip the VAE adds 1 flash for the encode and 1
    # per decode chunk, and its GroupNorms (22 per encode, 30 per chunk)
    if (want["per_eval"] != {"flash": 0, "small": 12, "packed": 20,
                             "fused_temporal": 22, "group_norm": 166}
            or want["encode"]["flash"] != 1
            or want["decode_chunk"]["flash"] != 1):
        raise AssertionError(f"the routing predicts {want}")
    if launches != {k: want[k] for k in KERNEL_KEYS}:
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
    check_model_bf16(device, args.seed)
    launches = run_slice(device, args.seed, args.ddim_steps)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[key], **summary[name]}
        for name, (key, src, tpu) in KERNELS.items()]}
    print(card, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
