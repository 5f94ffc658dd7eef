#!/usr/bin/env python3
"""Drive the PyTorch port (open_pandora_tpu_torch) once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--ddim-steps 10]

Phases, each printing its own lines and raising on failure:
  1. env      torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds the kernel library from csrc/ (or loads it)
  3. kernels  each CUDA kernel against its plain PyTorch version at every
              shape of the slices' main paths, plus ragged cases (and fp32
              ones for the kernels that take fp32); the backward kernels'
              dq, dk and dv each; kernel, plain and (where one PyTorch
              call computes the same function) library times from CUDA
              events, beside the bound (the least time for the work)
  4. model    a narrow DynamiCrafter at 320x512x16f: in fp32, DDIM-2 on the
              card (unfused route) against the same weights and noise on
              the CPU; in bf16, one CFG UNet eval and one 8-frame decode
              chunk on the card (the fused route) and on the CPU (the
              unfused route), both against fp32 on the CPU; in fp32, one
              finetune step on the card against the CPU (loss, gradients)
  5. slice    the full-width PandoraConfig() in bf16 through
              eval.inference.synthesize (the fused route); launch counts
              against the routing
  6. train    the full-width PandoraConfig() in bf16 through the trainer
              (train.trainer.run, stage dynamicrafter, synthetic data,
              3 steps at 320x512x16f); seconds per step, peak memory,
              losses, gradients at a spatial and a temporal attention
              projection, launch counts against the routing
The last three lines are the card's name and power limit, the kernels'
JSON summary and the run's JSON result.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import subprocess
import sys
import time

import os
import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

CSRC = "open_pandora_tpu_torch/csrc/"
# name -> (launch-count key, source, the Pallas kernel it replaces)
KERNELS = {
    "flash_fwd": ("flash", CSRC + "flash_fwd.cu",
                  "open_pandora_tpu/ops/flash_attention.py:92"),
    "flash_bwd": ("flash_bwd", CSRC + "flash_bwd.cu",
                  "open_pandora_tpu/ops/flash_attention.py:202"),
    "small_attn_fwd": ("small", CSRC + "small_attn_fwd.cu",
                       "open_pandora_tpu/ops/small_attention.py:60"),
    "small_attn_bwd": ("small_bwd", CSRC + "small_attn_bwd.cu",
                       "open_pandora_tpu/ops/small_attention.py:74"),
    "packed_attn_fwd": ("packed", CSRC + "packed_attn_fwd.cu",
                        "open_pandora_tpu/ops/packed_attention.py:104"),
    "fused_temporal_attn": ("fused_temporal", CSRC + "fused_temporal_attn.cu",
                            "open_pandora_tpu/ops/fused_temporal.py:33"),
    "group_norm_silu": ("group_norm", CSRC + "group_norm_silu.cu",
                        "open_pandora_tpu/ops/fused_norms.py:58"),
}
KERNEL_KEYS = tuple(key for key, _, _ in KERNELS.values())
# the kernels each main path runs
EVAL_KEYS = ("flash", "small", "packed", "fused_temporal", "group_norm")
TRAIN_KEYS = ("flash", "flash_bwd", "small", "small_bwd", "group_norm")


def wrappers() -> dict:
    """The kernel wrappers by launch-count key; each counts its launches."""
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_self_attention)
    from open_pandora_tpu_torch.ops.packed_attention import packed_attention
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_bwd)
    return {"flash": flash_attention, "flash_bwd": flash_attention_bwd,
            "small": small_attention, "small_bwd": small_attention_bwd,
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

# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet; dense,
# bf16 on the tensor cores, fp32 on the CUDA cores) and its memory rate
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    """The least time the card could take for work that must move `nbytes`
    (each input read once, each output written once) and do `flops` in
    `dtype`: the larger of the two times, and which one it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_pairs(n: int, m: int, causal: bool) -> int:
    """(query, key) pairs the attention must score: all n m, or with the
    suffix-aligned causal mask those with key <= row + m - n."""
    if not causal:
        return n * m
    return sum(min(m, max(0, r + m - n + 1)) for r in range(n))


def _kernel_bound(out, plain, ref32) -> tuple:
    """max|kernel - ref32| must stay within 2 max|plain - ref32| plus 1% of
    mean|ref32| (ref32: the plain version in fp32 on the same inputs)."""
    err = (out.float() - ref32).abs().max().item()
    plain_err = (plain.float() - ref32).abs().max().item()
    bound = 2 * plain_err + 1e-2 * ref32.abs().mean().item()
    return err, bound


def _record(summary: dict, name: str, case: dict, err: float, ok: bool,
            times: dict, work: tuple) -> None:
    """Log one case; the first case of each kernel goes into the summary.
    work: (bytes, flops, dtype) of the function at this case."""
    bms, by = bound_ms(*work)
    rec = {"max_abs_err": err, **times, "bound_ms": bms, "bound_by": by}
    rec.setdefault("library_ms", None)
    log("kernels", json.dumps({"kernel": name, **case, **rec, "ok": ok}))
    if not ok:
        raise AssertionError(f"{name} {case}: out of bound")
    summary.setdefault(name, rec)
    torch.cuda.empty_cache()


def _check(summary: dict, name: str, case: dict, kern, plain, ref32_fn,
           work: tuple, library=None) -> None:
    """Hold kern() to the bound against ref32_fn() (the plain version in
    fp32) with plain() (the plain version in the working dtype) setting
    the bound; time kern, plain and the library call if there is one."""
    out = kern()
    torch.cuda.synchronize()
    ref32 = ref32_fn()
    err, bound = _kernel_bound(out, plain(), ref32)
    del out, ref32
    times = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain)}
    if library is not None:
        times["library_ms"] = cuda_ms(library)
    ok = bool(np.isfinite(err) and err <= bound)
    _record(summary, name, {**case, "bound": bound}, err, ok, times, work)


def _heads_first(*ts):
    """(B, N, H, D) -> (B, H, N, D) views, the layout SDPA takes."""
    return [t.transpose(1, 2) for t in ts]


def _sdpa_mask(n, m, causal, device):
    from open_pandora_tpu_torch.ops.attention_xla import causal_mask
    return causal_mask(n, m, device) if causal else None


def check_kernels(device, gen) -> dict:
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal); the first rows are the slices' shapes
    flash_cases = [
        (1, 2560, 2560, 1, 512, bf16, False),   # VAE encoder mid-block
        (8, 2560, 2560, 1, 512, bf16, False),   # VAE decoder mid, per chunk
        (32, 2560, 2560, 5, 64, bf16, False),   # UNet attn1, unfused route
        (32, 640, 640, 10, 64, bf16, False),    # UNet attn1, 20x32
        (16, 2560, 2560, 5, 64, bf16, False),   # UNet attn1, training
        (16, 640, 640, 10, 64, bf16, False),
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
        (2560, 16, 16, 5, 64, bf16),   # temporal attn, training
        (5120, 16, 16, 2, 32, f32),    # narrow model (phase 4)
        (5120, 16, 16, 8, 32, f32),
        (100, 7, 16, 3, 48, f32),      # ragged N < M
    ]
    summary = {}

    def run(name, kern, plain, cases, flash):
        for case in cases:
            B, N, M, H, D, dt = case[:6]
            causal = case[6] if flash else False
            kw = {"causal": causal} if flash else {}
            q = torch.randn(B, N, H, D, generator=gen, device=device).to(dt)
            k = torch.randn(B, M, H, D, generator=gen, device=device).to(dt)
            v = torch.randn(B, M, H, D, generator=gen, device=device).to(dt)
            out = kern(q, k, v, **kw)
            torch.cuda.synchronize()
            ref32 = plain(q.float(), k.float(), v.float(), **kw)
            ref_dt = plain(q, k, v, **kw)
            extra = {}
            if flash:  # (o, lse); the LSE is fp32 on both sides
                (out, lse), (ref32, lse32), ref_dt = out, ref32, ref_dt[0]
                extra["lse_max_abs_err"] = (lse - lse32).abs().max().item()
            err, bound = _kernel_bound(out, ref_dt, ref32)
            del ref32, ref_dt
            mask = _sdpa_mask(N, M, causal, device)
            qs, ks, vs = _heads_first(q, k, v)
            times = {
                "ms": cuda_ms(lambda: kern(q, k, v, **kw)),
                "plain_ms": cuda_ms(lambda: plain(q, k, v, **kw)),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask))}
            # LSE: fp32 statistics of the same fp32 scores, summation order
            # only; 1e-3 is 1e-4 of its magnitude (about log M + max score)
            ok = bool(np.isfinite(err) and err <= bound
                      and extra.get("lse_max_abs_err", 0.0) <= 1e-3)
            pairs = attention_pairs(N, M, causal)
            nbytes = (2 * B * N + 2 * B * M) * H * D * q.element_size() \
                + flash * B * H * N * 4
            _record(summary, name, {
                "shape": [B, N, H, D], "M": M,
                "dtype": str(dt).replace("torch.", ""), **kw,
                "bound": bound, **extra}, err, ok, times,
                (nbytes, 4 * B * H * pairs * D, dt))
            del q, k, v, out

    run("flash_fwd", functools.partial(flash_attention, return_lse=True),
        flash_attention_plain, flash_cases, True)
    run("small_attn_fwd", small_attention, small_attention_plain,
        small_cases, False)
    check_attention_bwd(summary, device, gen)
    check_packed(summary, device, gen)
    check_fused_temporal(summary, device, gen)
    check_group_norm(summary, device, gen)
    return summary


def check_attention_bwd(summary: dict, device, gen) -> None:
    """The flash and small-attention backward kernels against their plain
    versions on the same q, k, v, do (and the forward's o and LSE): dq, dk
    and dv each held to the bound rule. The library yardstick is SDPA's
    forward and backward together (one autograd call)."""
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention_bwd, small_attention_bwd_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal): the training step's attn1 sites at
    # batch 1 (b*t = 16 frames), a causal N < M with a ragged M, the narrow
    # model's sites in fp32
    flash_cases = [
        (16, 2560, 2560, 5, 64, bf16, False),
        (16, 640, 640, 10, 64, bf16, False),
        (2, 1000, 1100, 4, 128, bf16, True),
        (2, 1000, 1100, 4, 128, f32, True),
        (16, 2560, 2560, 2, 32, f32, False),
        (16, 640, 640, 4, 32, f32, False),
    ]
    # the temporal sites at batch 1 (b*h*w positions, t = 16): 40x64,
    # 20x32, 10x16, 5x8 and init_attn; a ragged N = M = 7; the narrow
    # model's in fp32
    small_cases = [
        (2560, 16, 16, 5, 64, bf16),
        (640, 16, 16, 10, 64, bf16),
        (160, 16, 16, 20, 64, bf16),
        (40, 16, 16, 20, 64, bf16),
        (2560, 16, 16, 8, 64, bf16),
        (300, 7, 7, 3, 48, bf16),
        (2560, 16, 16, 2, 32, f32),
        (2560, 16, 16, 8, 32, f32),
    ]

    def rnd(*shape, dt):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    def hold(name, case, kern, plain, ref32_fn, library, work):
        outs = kern()
        torch.cuda.synchronize()
        ref32, plain_out = ref32_fn(), plain()
        errs, ok = {}, True
        for part, out, p, r in zip(("dq", "dk", "dv"), outs, plain_out,
                                   ref32):
            err, bound = _kernel_bound(out, p, r)
            errs[part] = {"max_abs_err": err, "bound": bound}
            ok = ok and bool(np.isfinite(err) and err <= bound)
        del outs, ref32, plain_out
        times = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                 "library_ms": cuda_ms(library)}
        _record(summary, name, {**case, **errs}, max(
            e["max_abs_err"] for e in errs.values()), ok, times, work)

    def sdpa_fwd_bwd(q, k, v, do, mask):
        def call():
            qs, ks, vs = (t.detach().requires_grad_()
                          for t in _heads_first(q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
            torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))
        return call

    for B, N, M, H, D, dt, causal in flash_cases:
        q, k, v = (rnd(B, n, H, D, dt=dt) for n in (N, M, M))
        do = rnd(B, N, H, D, dt=dt)
        o, lse = flash_attention_plain(q, k, v, causal=causal)
        args = (q, k, v, o, lse, do)
        pairs = attention_pairs(N, M, causal)
        nbytes = (4 * B * N + 4 * B * M) * H * D * q.element_size() \
            + B * H * N * 4
        hold("flash_bwd",
             {"shape": [B, N, H, D], "M": M,
              "dtype": str(dt).replace("torch.", ""), "causal": causal},
             lambda: flash_attention_bwd(*args, causal=causal),
             lambda: flash_attention_bwd_plain(*args, causal=causal),
             lambda: flash_attention_bwd_plain(
                 *[t.float() for t in args], causal=causal),
             sdpa_fwd_bwd(q, k, v, do, _sdpa_mask(N, M, causal, device)),
             (nbytes, 10 * B * H * pairs * D, dt))
        del q, k, v, do, o, lse, args

    for B, N, M, H, D, dt in small_cases:
        q, k, v = (rnd(B, n, H, D, dt=dt) for n in (N, M, M))
        do = rnd(B, N, H, D, dt=dt)
        args = (q, k, v, do)
        hold("small_attn_bwd",
             {"shape": [B, N, H, D], "M": M,
              "dtype": str(dt).replace("torch.", "")},
             lambda: small_attention_bwd(*args),
             lambda: small_attention_bwd_plain(*args),
             lambda: small_attention_bwd_plain(*[t.float() for t in args]),
             sdpa_fwd_bwd(q, k, v, do, None),
             ((3 * N + 4 * M) * B * H * D * q.element_size(),
              10 * B * H * N * M * D, dt))
        del q, k, v, do, args


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
        library = None
        if len(ms) == 1 and gate == 1.0:   # one stream: plain attention
            qs, ks, vs = _heads_first(q.view(B, N, H, D),
                                      *(t.view(B, ms[0], H, D)
                                        for t in streams[0]))

            def library():
                return F.scaled_dot_product_attention(qs, ks, vs)
        _check(summary, "packed_attn_fwd",
               {"shape": [B, N, H, D], "M": list(ms), "gate": gate,
                "dtype": str(dt).replace("torch.", "")},
               lambda: packed_attention(q, streams, g, heads=H),
               lambda: packed_attention_plain(q, streams, g, heads=H),
               lambda: packed_attention_plain(
                   q.float(), [(k.float(), v.float()) for k, v in streams],
                   g, heads=H),
               ((2 * N + 2 * sum(ms)) * B * hd * 2,
                4 * B * N * sum(ms) * hd, dt), library)
        del q, streams, library


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
        c, t = shape[-1], shape[1]
        rows = y.numel() // c
        # LN, four c x c projections, the t x t attention of every row
        _check(summary, "fused_temporal_attn",
               {"shape": list(shape), "heads": heads, "dtype": "bfloat16"},
               lambda: fused_temporal_self_attention(y, *params, heads=heads),
               lambda: fused_temporal_plain(y, *params, heads=heads),
               lambda: fused_temporal_plain(
                   y.float(), *[p.float() for p in params], heads=heads),
               ((2 * y.numel() + 4 * c * c + 3 * c) * 2,
                8 * rows * c * c + 4 * rows * t * c, torch.bfloat16))
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
        # statistics, normalise, scale, shift, SiLU: about 8 per element
        _check(summary, "group_norm_silu",
               {"shape": list(shape), "eps": eps, "silu": silu,
                "dtype": "bfloat16"},
               lambda: fused_group_norm_silu(x, w, b, **kw),
               lambda: group_norm(x, w, b, **kw),
               lambda: group_norm(x.float(), w.float(), b.float(), **kw),
               ((2 * x.numel() + 2 * c) * 2, 8 * x.numel(), torch.bfloat16))
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


# card against CPU for one fp32 finetune step: the loss and the gradient
# norm relative to themselves, each UNet gradient relative to its largest
# entry. fp32 on both sides, TF32 off: they differ in summation order only,
# through the forward, the checkpoint recompute and the backward of about
# 100 layers. The CPU test of the same step against the JAX package
# (tests/test_torch_train_step.py, tiny config) reads 1.1e-5 on the
# gradients; the bounds are some 20 times the readings expected here.
TRAIN_BOUND_LOSS = 1e-4
TRAIN_BOUND_GRAD = 1e-3


def zero_dropout_(model) -> None:
    """Dropout off everywhere, the temporal conv blocks' fixed 0.1 too."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0


def check_train_step(device, seed: int) -> None:
    """fp32: one finetune step of the narrow model on the card (flash and
    small attention forward and backward kernels under checkpointing) and
    on the CPU, from the same weights, batch and injected draws (posterior
    noise, CFG mask, timestep, diffusion noise), dropout 0."""
    from open_pandora_tpu_torch.core.config import TrainConfig
    from open_pandora_tpu_torch.eval.inference import build_model
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_finetune_step)

    cfg = narrow_config()
    tcfg = TrainConfig(learning_rate=1e-4, uncond_prob=0.5)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(seed + 4))
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed + 5)
    T = cfg.unet.temporal_length
    latent = (1, T, 40, 64, cfg.vae.z_channels)
    batch = {
        "video": rng.uniform(-1, 1, (1, T, 320, 512, 3)).astype(np.float32),
        "cond_frames": rng.uniform(-1, 1, (1, 1, 320, 512, 3)).astype(
            np.float32),
        "cond_images": rng.random((1, 256, 256, 3), np.float32),
        "text_tokens": rng.integers(1, 49000, (1, 77)),
        "fps": np.asarray([3]),
    }
    draws = {"eps": torch.from_numpy(rng.standard_normal(latent, np.float32)),
             "uncond": torch.tensor([False]), "t": torch.tensor([500]),
             "noise": torch.from_numpy(rng.standard_normal(latent,
                                                           np.float32))}
    got = {}
    for name, model in (("card", card), ("cpu", cpu)):
        zero_dropout_(model)
        state = TrainState.create(model, "dynamicrafter", tcfg)
        reset_launches()
        t0 = time.perf_counter()
        m = make_finetune_step(model, tcfg)(state, batch, draws=draws)
        m = {k: float(v) for k, v in m.items()}
        got[name] = (m, {k: p.grad.float().cpu()
                         for k, p in state.trainable.items()},
                     read_launches())
        log("model", f"train step {name}: {time.perf_counter() - t0:.1f} s, "
            f"{json.dumps(m)}")
    (mc, gc, launches), (mr, gr, _) = got["card"], got["cpu"]
    loss_err = abs(mc["loss"] - mr["loss"]) / mr["loss"]
    norm_err = abs(mc["grad_norm"] - mr["grad_norm"]) / mr["grad_norm"]
    grad_err = max((gc[k] - g).abs().max().item()
                   / max(g.abs().max().item(), 1e-12) for k, g in gr.items())
    ok = (np.isfinite(mc["loss"]) and loss_err <= TRAIN_BOUND_LOSS
          and norm_err <= TRAIN_BOUND_LOSS and grad_err <= TRAIN_BOUND_GRAD)
    want = predicted_train_launches(cfg, 320, 512, batch=1, frames=T + 1,
                                    bf16=False)
    log("model", json.dumps({
        "dtype": "float32", "train_step": True, "loss": mc["loss"],
        "loss_rel_err": loss_err, "grad_norm": mc["grad_norm"],
        "grad_norm_rel_err": norm_err, "grad_max_rel_err": grad_err,
        "bounds": [TRAIN_BOUND_LOSS, TRAIN_BOUND_GRAD],
        "launches": launches, "predicted": want, "ok": bool(ok)}))
    if not ok:
        raise AssertionError("card and CPU train steps disagree")
    if launches != want:
        raise AssertionError(f"train step launches {launches} != {want}")


# -- phase 5: the slice at full width -----------------------------------------

def predicted_launches(cfg, height: int, width: int, steps: int,
                       frame_chunk: int, fused: bool, batch: int = 2
                       ) -> dict:
    """Kernel launches of one synthesize() call, derived from the model's
    structure and the port's gates on the shapes each site sees: the
    dispatcher's routes (attention_route), and on the fused route (bf16
    eval on a CUDA device) the packed, fused temporal and GroupNorm gates.
    Batched CFG runs cond and uncond as batch 2 (`batch`). Returns the
    counts per UNet eval ("per_eval"), per VAE encode and decode chunk, and
    for the clip (one key per kernel)."""
    from open_pandora_tpu_torch.ops.attention import attention_route
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_eligible)
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention_eligible)

    def route(q, k):
        return attention_route(q, k, causal=False, masked=False,
                               on_device=True)

    u, v = cfg.unet, cfg.vae
    b, t, d = batch, u.temporal_length, u.num_head_channels
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


def predicted_train_launches(cfg, height: int, width: int, batch: int,
                             frames: int, bf16: bool) -> dict:
    """Kernel launches of one finetune step: the UNet in training takes the
    unfused route (flash and small attention), forward once, again in the
    backward where cfg.unet.use_checkpoint recomputes each block, and each
    attention's backward kernel once; the frozen VAE encodes `frames`
    frames one at a time (the video and the conditioning frames) in eval,
    on its GroupNorm kernel in bf16. The text and image encoders launch
    none of these kernels (their attention takes the plain route)."""
    unet = predicted_launches(cfg, height, width, 1, frame_chunk=1,
                              fused=False, batch=batch)["per_eval"]
    encode = predicted_launches(cfg, height, width, 1, frame_chunk=1,
                                fused=bf16)["encode"]
    fwd = 2 if cfg.unet.use_checkpoint else 1
    counts = {k: frames * encode[k] for k in KERNEL_KEYS}
    for key, bwd in (("flash", "flash_bwd"), ("small", "small_bwd")):
        counts[key] += fwd * unet[key]
        counts[bwd] += unet[key]
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
    if (want["per_eval"] != {"flash": 0, "flash_bwd": 0, "small": 12,
                             "small_bwd": 0, "packed": 20,
                             "fused_temporal": 22, "group_norm": 166}
            or want["encode"]["flash"] != 1
            or want["decode_chunk"]["flash"] != 1):
        raise AssertionError(f"the routing predicts {want}")
    if launches != {k: want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"launches {launches} != predicted {want}")
    if min(launches[k] for k in EVAL_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return launches


# -- phase 6: the trainer at full width ---------------------------------------

TRAIN_STEPS = 3


def run_train(device, seed: int) -> dict:
    """The port's trainer on the full-width PandoraConfig() in bf16
    (stage dynamicrafter, synthetic data, batch 1 at 320x512x16f), a few
    steps into a temporary logdir removed afterwards."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.train import trainer

    cfg = PandoraConfig()
    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.run([
            "--synthetic-data", "--max-steps", str(TRAIN_STEPS),
            "--logdir", logdir, "--name", "phase6", "--device", "cuda",
            "--set", "train.stage=dynamicrafter",
            "--set", "train.log_every=1", "--set", f"train.seed={seed}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logdir, "phase6", "loginfo",
                               "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    unet = state.model.model.diffusion_model
    # attn1's query projection reaches the loss only through the attention
    # kernels' dq: level 0 spatial (flash, 2560 tokens) and temporal (small)
    sites = {"spatial_l0_attn1_to_q":
             unet.input_blocks[1][1].transformer_blocks[0].attn1.to_q.weight,
             "temporal_l0_attn1_to_q":
             unet.input_blocks[1][2].transformer_blocks[0].attn1.to_q.weight}
    grad_norms = {k: p.grad.float().norm().item() for k, p in sites.items()}
    n_params = sum(p.numel() for p in state.trainable.values())
    del state, unet, sites
    torch.cuda.empty_cache()
    want = predicted_train_launches(cfg, cfg.train.height, cfg.train.width,
                                    batch=1,
                                    frames=cfg.train.video_length + 1,
                                    bf16=True)
    report = {
        "config": "PandoraConfig() bf16", "steps": TRAIN_STEPS,
        "trainable_parameters": n_params, "wall_s": wall,
        "sec_per_step": [r["sec_per_step"] for r in recs],
        "loss": [r["loss"] for r in recs],
        "loss_simple": [r["loss_simple"] for r in recs],
        "grad_norm": [r["grad_norm"] for r in recs],
        "attention_grad_norms": grad_norms, "max_memory_allocated": peak,
        "launches": launches, "predicted_per_step": want}
    log("train", json.dumps(report))
    finite = all(np.isfinite(r[k]) for r in recs
                 for k in ("loss", "loss_simple", "grad_norm"))
    if len(recs) != TRAIN_STEPS or not finite:
        raise AssertionError(f"bad train metrics {recs}")
    if min(r["grad_norm"] for r in recs) <= 0 or min(
            grad_norms.values()) <= 0:
        raise AssertionError(f"zero gradients: {recs} {grad_norms}")
    # per step, PandoraConfig() at 320x512: 10 flash attn1 sites and 34
    # temporal sites, forward twice (checkpoint recompute) and backward
    # once; 17 VAE encodes (16 frames and the conditioning frame), each
    # with one flash and 22 GroupNorm launches
    if (want["flash_bwd"], want["small_bwd"], want["small"], want["flash"],
            want["group_norm"]) != (10, 34, 68, 37, 374):
        raise AssertionError(f"the routing predicts {want}")
    if launches != {k: TRAIN_STEPS * want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"launches {launches} != {TRAIN_STEPS} x "
                             f"{want}")
    if min(launches[k] for k in TRAIN_KEYS) <= 0:
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
    check_train_step(device, args.seed)
    paths = {"eval": run_slice(device, args.seed, args.ddim_steps),
             "train": run_train(device, args.seed)}

    # launches: the two main paths' runs together, and each on its own
    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(p[key] for p in paths.values()),
         "launches_by_path": {n: p[key] for n, p in paths.items()},
         **summary[name]}
        for name, (key, src, tpu) in KERNELS.items()]}
    print(card, flush=True)
    print(json.dumps(kernels_line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
