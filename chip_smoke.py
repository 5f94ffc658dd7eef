#!/usr/bin/env python3
"""Drive the PyTorch port (open_pandora_tpu_torch) once on one CUDA card.

Run from the repository root:

    python3 chip_smoke.py [--seed 0] [--ddim-steps 10]

Phases, each printing its own lines and raising on failure:
  1. env      torch / CUDA versions, the card's name and power limit
  2. build    nvcc builds the kernel library from csrc/ (or loads it)
  3. kernels  each CUDA kernel against its plain PyTorch version at every
              shape of the slices' main paths (320x512 and 576x1024), plus
              ragged cases (and fp32 ones for the kernels that take fp32;
              rows 1, 2 and 9-13 at fp32 also within 8
              max|ref32 - ref64| of the float64 plain version, and at the
              full-width fp32 shapes: an fp32 training step's and an fp32
              clip's);
              the packed kernel in its long-key regime and the dual
              cross-attention kernel under their own names; the backward
              kernels' dq, dk and dv each; the conv kernel as the direct
              conv (row 11) and the fused conv (row 12, with and without
              its prologue and residual) at every routed conv site of
              both resolutions and an edge-heavy shift, in bf16 and, at
              B = 32, in fp32 in the variants each route takes there
              (cuDNN's fp32 conv beside it, TF32 off and, for context,
              on: `library_tf32_ms`); the GEGLU kernel
              at the UNet's feed-forward widths in bf16 and fp32 (its
              eager chain beside it, in fp32 TF32 off and, for context,
              on: `eager_tf32_ms`); the fused temporal kernel
              and the GroupNorm kernel at every shape a trace of the UNet
              hands them at either resolution, the fused temporal lines
              naming the kernel taken, beside its eager PyTorch chain
              (`eager_ms`), the GroupNorm lines the launch plan's splits;
              kernel, plain and (where one
              PyTorch call computes the same function) library times from
              CUDA events, beside the bound (the least time for the work);
              the flash kernel's k16 tail (D = 72), causal rows with no
              allowed key (N > M) and LLaMA's causal prefill; shapes a gate
              refuses, and packed rows off 16-byte alignment, raise in the
              wrapper; SVD-XT's sites at 576x1024x25 (row 13 at its
              feed-forwards' rows, row 2 at t = 25, and row 4 there beside
              the route the model takes, which it lost to), each beside
              the port's eager route (`port_eager_ms`)
  4. model    a narrow DynamiCrafter at 320x512x16f: in fp32, DDIM-2 on the
              card (unfused route) against the same weights and noise on
              the CPU; in bf16, one CFG UNet eval and one 8-frame decode
              chunk on the card (the fused route) and on the CPU (the
              unfused route), both against fp32 on the CPU, and the same
              UNet eval at head width 48 (the dual cross-attention route);
              in fp32, one finetune step on the card against the CPU (loss,
              gradients); a narrow WorldModel in fp32: the cluster indices
              and the conditioning of a 2-round prompt, card against CPU
  5. slice    the full-width PandoraConfig() in bf16 through
              eval.inference.synthesize (the fused route); launch counts
              against the routing; then (5b) one full-width CFG UNet eval
              at head width 80, where attn2 takes the dual cross-attention
              kernel
  5c. conv    the same model's UNet under the opt-in conv flags (set with
              core.flags.overridden): one CFG eval at 320x512 on the
              default route, under PANDORA_ENABLE_PCONV2 and under
              PANDORA_ENABLE_PCONV, each held to the default route by the
              bf16 rule against an fp32 copy on the card, launches against
              the census; synthesize() DDIM-2 and one CFG eval at 576x1024
              under PANDORA_ENABLE_PCONV2
  5d. conv_fp32 PandoraConfig()'s UNet in fp32 (random weights): one CFG
              eval at 320x512 on the default route, under
              PANDORA_ENABLE_PCONV2 and under PANDORA_ENABLE_PCONV (the 23
              routed sites on the fp32 conv kernel, rows 3-5 not at all):
              launches against the routing, eps within 1e-3 max|eps| of
              the default route's, the distance from the default route
              with TF32 allowed beside it, seconds per eval
  5e. svd     one CFG eval of svd_xt's VideoUNet (SVDConfig()) in bf16 at
              576x1024x25 (random weights): launch counts against its
              routing, seconds per eval
  6. train    the full-width PandoraConfig() in bf16 through the trainer
              (train.trainer.run, stage dynamicrafter, synthetic data,
              3 steps at 320x512x16f); seconds per step, peak memory,
              losses, gradients at a spatial and a temporal attention
              projection, launch counts against the routing
  6b. train_fp32 the same under dtype_policy=fp32 (the JAX trainer's
              precision: rows 1, 2, 9 and 10 on their fp32 kernels, 37
              flash, 10 flash backward, 68 small and 34 small backward
              launches a step); seconds per step, peak memory, losses,
              gradients, launches against the routing
  7. world    the full-width PandoraConfig() WorldModel in bf16 (32-layer
              LLaMA, 24-layer CLIP tower, 12-layer Q-Former, the diffusion
              stack) through pipeline.chat_wm.ChatWM at 576x1024, two
              rounds of DDIM-4: per round the conditioning's parts, seconds
              per DDIM step, decode, the spliced prompt length; frames,
              peak memory, launch counts against the routing
  8. train_llm the LLM training stages on that WorldModel at full width,
              bf16, batch 1, 2 steps each: finetune through the trainer
              (320x512x16f), then alignment, llm_sft in full and llm_sft
              with LoRA (r 64, alpha 16) through their step functions on
              one WorldModel; per stage loss, gradient norm, seconds per
              step, peak memory, launches against the routing, the
              connector's prefix-row gradient (alignment, finetune) and
              which tensors LoRA moved
  9. entry    the user's entry points on the full-width PandoraConfig()
              WorldModel (bf16, 320x512, random weights): cli.build_chat
              from parsed defaults, cli.run with two actions at DDIM-4,
              then server.make_server on 127.0.0.1 in a thread around the
              same session (/health, the page, two POST /generate whose
              injected generate_fn reads and answers np.save bytes); per
              call the rounds' seconds by part and launches against the
              routing, the first request's frames equal to cli.run's
 10. train_hires the product's 576x1024 finetune (configs/finetune_1024.yaml)
              through the trainer, 2 steps, a sample grid at step 2,
              TensorBoard and CSV loggers: once as it is, once under
              PANDORA_FINE_REMAT; per run seconds per step, peak memory
              of each step's forward and backward, of its optimizer step
              and of the sample, loss, gradient norm, launches
              against the routing; the sample grid's PNG size, the CSV's
              rows and the event file's first record's CRCs checked, the
              two runs' first losses within 1e-3
 11. multi    the parallel layer in a process of its own that opens a
              world-size-1 NCCL group through parallel.launch
              .init_distributed: on the full-width PandoraConfig() in bf16,
              sharded_synthesis at 320x512 DDIM-4 and sharded_decode, the
              dynamicrafter step at 320x512 under configs/finetune.yaml's
              mesh (DDP + ZeRO-2, then with FSDP) and train.trainer.run
              of it for 2 steps (metrics and checkpoint checked),
              the LLaMA-7B prefill under tensor parallelism (1024 rows),
              in bf16 and with the int8 layout, and sp_llama_prefill on
              phase 7's round-2 prompt (384 rows); each held to its
              one-device call of the same seed (max|d|), with wall
              seconds and peak memory beside the one-device call's, and
              launches against it
 12. decode   LLaMAConfig() in bf16, then quantized on the card to int8,
              then to NF4 (models/quant.py), one at a time: weight bytes,
              the prefill of phase 7's round-2 prompt plus 128 text rows
              (512 rows: the flash route), greedy_generate of 32 tokens
              (its prefill and its decode loop timed apart, the loop
              twice), ms per token and launches per token
              (torch.profiler), the peak while quantizing and while
              decoding; first-token logits against bf16; the bf16 KV
              decode's first 8 steps against a re-prefill of prompt +
              tokens by phase 3's rule, the fp32 reference on the plain
              attention route. Then cli.build_chat with --quantize-llm (int8) and
              cli.run of two actions at 320x512, DDIM-4 (seconds by part,
              launches against the routing, peak) and the last round's
              conditioning with --quantize-llm nf4; the answer runners'
              cores (eval/chatunivi_qa, scienceqa, consistency) on the
              full-width WorldModel, 16 new tokens, their records' fields;
              EVA-ViT-g at full width on 1 and 17 images (ms, peak); the
              narrow WorldModel of phase 4 with the EVA tower and with
              the text transformer over the connector, card against CPU
 13. tools    this slice's modules: (a) eval.vbench.run on the full-width
              PandoraConfig() WorldModel (bf16, 320x512, cli.build_chat):
              two metadata items with synthetic uint8 crops, 2 samples
              each at DDIM-4, seconds per clip by part, launches against
              the routing, the four file names, a sample run again to
              equal frames and seeds 0 and 1 apart; (b) tools.fused_drift
              at full width, 320x512, DDIM-2, with the upcast fp32 run
              as witness: every value finite, the routes within 8% of
              each other, the fused route no more than 1.5x the unfused
              route's distance from fp32; (c)
              tools.profile_unet (3 calls) and tools.clip_ab (DDIM-2 and
              DDIM-4): ms per CFG eval and the slope per DDIM step; (d) the
              alternative encoders (models/encoders_extra.py) at their
              full-size defaults in bf16 (ms, peak), then at narrow widths
              in fp32, card against CPU; (e) tools.hires_train_probe at
              576x1024, 2 steps, adamw8bit and then adamw: seconds per
              step and peak beside phase 10's; (f) tools.activation_dump on phase 4's
              narrow UNet (8x8 latent), card against CPU: the largest
              relative row
The run's wall time, then the last three lines are the card's name and power limit, the kernels'
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
    # the same kernel in its long-key regime (an online softmax across the
    # TPU kernel's key blocks), counted and checked on its own
    "packed_multi": ("packed_multi", CSRC + "packed_attn_fwd.cu",
                     "open_pandora_tpu/ops/packed_attention.py:170"),
    "dual_cross": ("dual_cross", CSRC + "dual_cross_attn_fwd.cu",
                   "open_pandora_tpu/ops/dual_cross_attention.py:45"),
    "fused_temporal_attn": ("fused_temporal", CSRC + "fused_temporal_attn.cu",
                            "open_pandora_tpu/ops/fused_temporal.py:33"),
    "group_norm_silu": ("group_norm", CSRC + "group_norm_silu.cu",
                        "open_pandora_tpu/ops/fused_norms.py:58"),
    # one source, launched under two names: the direct conv (row 11) and the
    # fused GroupNorm+SiLU -> conv -> bias + residual (row 12)
    "conv3x3": ("conv3x3", CSRC + "conv3x3.cu",
                "open_pandora_tpu/ops/conv2d.py:398"),
    "conv3x3_fused": ("conv3x3_fused", CSRC + "conv3x3.cu",
                      "open_pandora_tpu/ops/conv2d.py:244"),
    "fused_geglu": ("fused_geglu", CSRC + "fused_geglu.cu",
                    "open_pandora_tpu/ops/fused_geglu.py:62"),
}
KERNEL_KEYS = tuple(key for key, _, _ in KERNELS.values())
# the kernels each main path runs
EVAL_KEYS = ("flash", "small", "packed", "fused_temporal", "group_norm")
TRAIN_KEYS = ("flash", "flash_bwd", "small", "small_bwd", "group_norm")
TRAIN_FP32_KEYS = ("flash", "flash_bwd", "small", "small_bwd")  # phase 6b
WORLD_KEYS = EVAL_KEYS + ("packed_multi",)      # a ChatWM round at 576x1024
WIDE_HEAD_KEYS = ("flash", "small", "dual_cross", "group_norm")


def wrappers() -> dict:
    """The kernel wrappers by launch-count key; each counts its launches."""
    from open_pandora_tpu_torch.ops.conv2d import conv3x3_fused, conv3x3_nhwc
    from open_pandora_tpu_torch.ops.dual_cross_attention import (
        dual_cross_attention)
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from open_pandora_tpu_torch.ops.fused_geglu import fused_geglu_ff
    from open_pandora_tpu_torch.ops.fused_norms import fused_group_norm_silu
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_self_attention)
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_multi)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_bwd)
    return {"flash": flash_attention, "flash_bwd": flash_attention_bwd,
            "small": small_attention, "small_bwd": small_attention_bwd,
            "packed": packed_attention,
            "packed_multi": packed_attention_multi,
            "dual_cross": dual_cross_attention,
            "fused_temporal": fused_temporal_self_attention,
            "group_norm": fused_group_norm_silu,
            "conv3x3": conv3x3_nhwc, "conv3x3_fused": conv3x3_fused,
            "fused_geglu": fused_geglu_ff}


def reset_launches() -> None:
    for fn in wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {key: fn.launches for key, fn in wrappers().items()}


# readings one phase keeps for a later one to print beside its own
READINGS = {}


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

# peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet; dense)
# and its memory rate: bf16 on the tensor cores; fp32 as split TF32, three
# TF32 products for each fp32 one (495 TFLOP/s / 3), since a kernel
# accurate to fp32 can run there and so pass the CUDA cores' 67 TFLOP/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12
# the fp32 cases of rows 1, 2 and 9-13, beside the rule of _kernel_bound:
# max|kernel - ref64| within REF64_FACTOR max|ref32 - ref64| (ref64: the
# plain version in float64 on the same inputs). One TF32 pass meets the
# 1%-of-the-mean rule; it misses this one by orders of magnitude
# (tests/test_torch_train_ops.py holds both to it on the CPU).
REF64_FACTOR = 8


def _ref64_chunk(h: int, n: int, m: int) -> int:
    """Batch slices of the float64 plain versions: at most about 2.5e8
    float64 scores (2 GB) at once."""
    return max(1, int(2.5e8 // (h * n * m)))


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


def _ref64_bound(out, ref32, ref64) -> tuple:
    """max|out - ref64| and its bound, REF64_FACTOR max|ref32 - ref64|."""
    err = (out.double() - ref64).abs().max().item()
    bound = REF64_FACTOR * (ref32.double() - ref64).abs().max().item()
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
           work: tuple, library=None, timed=None, ref64_fn=None) -> None:
    """Hold kern() to the bound against ref32_fn() (the plain version in
    fp32) with plain() (the plain version in the working dtype) setting
    the bound, and, given ref64_fn (the plain version in float64), to the
    ref64 rule too; time kern, plain, the library call if there is one and
    any other yardstick in `timed` (name -> call)."""
    out = kern()
    torch.cuda.synchronize()
    ref32 = ref32_fn()
    err, bound = _kernel_bound(out, plain(), ref32)
    extra = {}
    if ref64_fn is not None:
        (extra["ref64_max_abs_err"],
         extra["ref64_bound"]) = _ref64_bound(out, ref32, ref64_fn())
    del out, ref32
    times = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain)}
    if library is not None:
        times["library_ms"] = cuda_ms(library)
    for key, fn in (timed or {}).items():
        times[key] = cuda_ms(fn)
    ok = bool(np.isfinite(err) and err <= bound
              and extra.get("ref64_max_abs_err", 0.0)
              <= extra.get("ref64_bound", 0.0))
    _record(summary, name, {**case, "bound": bound, **extra}, err, ok,
            times, work)


def _heads_first(*ts):
    """(B, N, H, D) -> (B, H, N, D) views, the layout SDPA takes."""
    return [t.transpose(1, 2) for t in ts]


def _sdpa_mask(n, m, causal, device):
    from open_pandora_tpu_torch.ops.attention_xla import causal_mask
    return causal_mask(n, m, device) if causal else None


def check_kernels(device, gen) -> dict:
    summary = {}
    check_flash(summary, device, gen)
    check_small(summary, device, gen)
    check_attention_bwd(summary, device, gen)
    check_packed(summary, device, gen)
    check_dual_cross(summary, device, gen)
    check_fused_temporal(summary, device, gen)
    check_group_norm(summary, device, gen)
    check_conv(summary, device, gen)
    check_geglu(summary, device, gen)
    check_svd_sites(summary, device, gen)
    check_refusals(device)
    return summary


def _attention_qkv(rnd, B, N, M, H, D, layout=None):
    """q (B, N, H, D), k and v (B, M, H, D) from rnd(*shape): contiguous;
    "packed": head-dim-contiguous views of one (B, N, 3, H, D) projection;
    "offset": q a view 4 elements into rows of D + 8, so that its base is
    8 bytes off 16-byte alignment (bf16 then takes the scalar kernel);
    "offset1": q a view 1 element into rows of D + 4, 4 bytes off (fp32
    then takes 4-byte copies)."""
    if layout == "packed":
        return rnd(B, N, 3, H, D).unbind(2)
    if layout == "offset":
        q = rnd(B, N, H, D + 8)[..., 4:4 + D]
    elif layout == "offset1":
        q = rnd(B, N, H, D + 4)[..., 1:1 + D]
    else:
        q = rnd(B, N, H, D)
    return q, rnd(B, M, H, D), rnd(B, M, H, D)


def _sdpa_views(*ts):
    """(B, H, N, D) views for SDPA, of contiguous copies where an fp32 row
    is off 16-byte alignment: PyTorch's fp32 SDPA kernel faulted on such a
    view (misaligned address) on the card."""
    return _heads_first(*[
        t.contiguous() if t.dtype == torch.float32 and t.data_ptr() % 16
        else t for t in ts])


def _check_attention(summary: dict, name: str, kern, plain, cases,
                     flash: bool, device, gen) -> None:
    """Hold an attention kernel on (B, N, H, D) operands to the bound rule
    at each (B, N, M, H, D, dtype[, causal]) case; the flash kernel's LSE
    within 1e-3 too, and every fp32 case to the ref64 rule. SDPA on the
    same operands is the library time."""
    for case in cases:
        B, N, M, H, D, dt = case[:6]
        causal = case[6] if flash else False
        layout = case[6 + flash] if len(case) > 6 + flash else None
        kw = {"causal": causal} if flash else {}
        q, k, v = _attention_qkv(
            lambda *s: torch.randn(*s, generator=gen, device=device).to(dt),
            B, N, M, H, D, layout)
        out = kern(q, k, v, **kw)
        torch.cuda.synchronize()
        # the plain version by batch slices where its fp32 scores exceed
        # 8 GB: (16, 9216, 9216, 5 heads) is 27 GB in one piece
        chunk = B if B * H * N * M <= 2e9 else max(1, int(2e9 // (H * N * M)))
        plain_b = _by_batch(functools.partial(plain, **kw), chunk)
        ref32 = plain_b(q.float(), k.float(), v.float())
        ref_dt = plain_b(q, k, v)
        extra = {}
        if flash:  # (o, lse); the LSE is fp32 on both sides
            (out, lse), (ref32, lse32), ref_dt = out, ref32, ref_dt[0]
            extra["lse_max_abs_err"] = (lse - lse32).abs().max().item()
        if dt == torch.float32:
            ref64 = _by_batch(functools.partial(plain, **kw),
                              _ref64_chunk(H, N, M))(
                q.double(), k.double(), v.double())
            ref64 = ref64[0] if flash else ref64
            (extra["ref64_max_abs_err"],
             extra["ref64_bound"]) = _ref64_bound(out, ref32, ref64)
            del ref64
        err, bound = _kernel_bound(out, ref_dt, ref32)
        del ref32, ref_dt
        mask = _sdpa_mask(N, M, causal, device)
        qs, ks, vs = _sdpa_views(q, k, v)
        times = {
            "ms": cuda_ms(lambda: kern(q, k, v, **kw)),
            "plain_ms": cuda_ms(lambda: plain_b(q, k, v)),
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask))}
        # LSE: fp32 statistics of the same fp32 scores, summation order
        # only; 1e-3 is 1e-4 of its magnitude (about log M + max score)
        ok = bool(np.isfinite(err) and err <= bound
                  and extra.get("lse_max_abs_err", 0.0) <= 1e-3
                  and extra.get("ref64_max_abs_err", 0.0)
                  <= extra.get("ref64_bound", 0.0))
        pairs = attention_pairs(N, M, causal)
        nbytes = (2 * B * N + 2 * B * M) * H * D * q.element_size() \
            + flash * B * H * N * 4
        _record(summary, name, {
            "shape": [B, N, H, D], "M": M,
            "dtype": str(dt).replace("torch.", ""), **kw,
            **({"layout": layout} if layout else {}),
            "bound": bound, **extra}, err, ok, times,
            (nbytes, 4 * B * H * pairs * D, dt))
        del q, k, v, out


def check_flash(summary: dict, device, gen, dtypes=None) -> None:
    """Row 1 at every case, or only at those whose dtype is in `dtypes`."""
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal); the first rows are the slices' shapes
    cases = [
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
        (2, 9216, 9216, 1, 512, bf16, False),   # VAE mid at 576x1024, chunk 2
        (1, 9216, 9216, 1, 512, bf16, False),   # VAE encode at 576x1024
        (32, 2560, 2560, 4, 80, bf16, False),   # attn1 at head width 80 (5b)
        (32, 640, 640, 8, 80, bf16, False),
        (32, 2560, 2560, 2, 48, bf16, False),   # head width 48 (phase 4)
        (2, 1000, 1000, 4, 72, bf16, False),    # D % 16 == 8: the k16 tail
        (2, 1100, 1000, 4, 128, bf16, True),    # causal, N > M: rows with
        (2, 1100, 1000, 4, 128, f32, True),     # no allowed key
        # fp32 at full width: attn1 and the VAE encode of a training step
        # under dtype_policy=fp32 (phase 6b), attn1 of an fp32 clip and
        # the VAE decode chunk (phase 13's fp32 witness; above)
        (16, 2560, 2560, 5, 64, f32, False),
        (16, 640, 640, 10, 64, f32, False),
        (1, 2560, 2560, 1, 512, f32, False),
        (32, 2560, 2560, 5, 64, f32, False),
        (32, 640, 640, 10, 64, f32, False),
        # the fp32 tiles' edges: a head of 320 (the wide tile below its
        # 512), ragged and causal; q 4 bytes off 16-byte alignment (4-byte
        # copies) at both tiles
        (2, 700, 300, 3, 320, f32, False),
        (2, 1100, 1000, 2, 320, f32, True),
        (2, 700, 300, 3, 64, f32, False, "offset1"),
        (2, 700, 300, 1, 512, f32, False, "offset1"),
        (1, 384, 384, 32, 128, bf16, True),     # LLaMA's causal prefill
        (1, 512, 512, 32, 128, bf16, True),     # phase 12's decode prefill
        (1, 520, 520, 32, 128, bf16, True),     # and its re-prefill check
        (1, 1024, 1024, 32, 128, bf16, True),   # phase 11's TP prefill
        # attn1 of a 576x1024 training step (unfused route), levels 0-2
        (16, 9216, 9216, 5, 64, bf16, False),
        (16, 2304, 2304, 10, 64, bf16, False),
        (16, 576, 576, 20, 64, bf16, False),
    ]
    cases = [c for c in cases if dtypes is None or c[5] in dtypes]
    _check_attention(summary, "flash_fwd",
                     functools.partial(flash_attention, return_lse=True),
                     flash_attention_plain, cases, True, device, gen)


def check_small(summary: dict, device, gen, dtypes=None) -> None:
    """Row 2 at every case, or only at those whose dtype is in `dtypes`."""
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        (320, 16, 16, 20, 64, bf16),   # 1280-channel temporal, 10x16
        (80, 16, 16, 20, 64, bf16),    # middle block 5x8
        (5120, 16, 16, 5, 64, bf16),   # temporal attn, 40x64, unfused route
        (5120, 16, 16, 8, 64, bf16),   # init_attn, unfused route
        (1280, 16, 16, 10, 64, bf16),  # 20x32, unfused route
        (2560, 16, 16, 5, 64, bf16),   # temporal attn, training
        (5120, 16, 16, 2, 32, f32),    # narrow model (phase 4)
        (5120, 16, 16, 8, 32, f32),
        (100, 7, 16, 3, 48, f32),      # ragged N < M
        # fp32 at full width: the temporal sites of a training step under
        # dtype_policy=fp32 (phase 6b; batch 1: 40x64, 20x32, 10x16, 5x8
        # and init_attn), then of an fp32 clip's CFG eval (batch 2)
        (2560, 16, 16, 5, 64, f32),
        (640, 16, 16, 10, 64, f32),
        (160, 16, 16, 20, 64, f32),
        (40, 16, 16, 20, 64, f32),
        (2560, 16, 16, 8, 64, f32),
        (5120, 16, 16, 5, 64, f32),
        (1280, 16, 16, 10, 64, f32),
        (320, 16, 16, 20, 64, f32),
        (80, 16, 16, 20, 64, f32),
        (5120, 16, 16, 8, 64, f32),
        # the fp32 kernel's edges: D = 36 (a k8 tail of 4), D = 72 (the
        # D <= 128 instance), q, k, v as strided views of one packed
        # projection, q 4 bytes off 16-byte alignment (4-byte copies)
        (300, 16, 16, 4, 36, f32),
        (300, 16, 16, 4, 72, f32),
        (320, 16, 16, 20, 64, f32, "packed"),
        (320, 16, 16, 20, 64, f32, "offset1"),
        (1152, 16, 16, 20, 64, bf16),  # 1280-channel temporal at 576x1024
        (288, 16, 16, 20, 64, bf16),
        (5120, 16, 16, 4, 80, bf16),   # temporal sites at head width 80 (5b)
        (5120, 16, 16, 8, 80, bf16),   # init_attn, 8 heads of 80
        (320, 16, 16, 16, 80, bf16),
        (5120, 16, 16, 2, 48, bf16),   # head width 48 (phase 4)
        # the tensor-core kernel's edges: ragged N < M, the k16 tail
        # (D = 72), q, k, v as strided views of one packed projection;
        # D = 36 (D % 8 != 0) and a q off 16-byte alignment take the
        # scalar kernel
        (100, 7, 16, 3, 48, bf16),
        (300, 16, 16, 4, 72, bf16),
        (320, 16, 16, 20, 64, bf16, "packed"),
        (300, 16, 16, 4, 36, bf16),
        (320, 16, 16, 20, 64, bf16, "offset"),
        # the temporal sites of a 576x1024 training step, levels 0-2
        (9216, 16, 16, 5, 64, bf16),
        (2304, 16, 16, 10, 64, bf16),
        (576, 16, 16, 20, 64, bf16),
    ]
    cases = [c for c in cases if dtypes is None or c[5] in dtypes]
    _check_attention(summary, "small_attn_fwd", small_attention,
                     small_attention_plain, cases, False, device, gen)


def check_attention_bwd(summary: dict, device, gen, dtypes=None) -> None:
    """The flash and small-attention backward kernels against their plain
    versions on the same q, k, v, do (and the forward's o and LSE): dq, dk
    and dv each held to the bound rule (the fp32 cases to the ref64 rule
    too). The library yardstick is SDPA's forward and backward
    together (one autograd call). Every case, or those whose dtype is in
    `dtypes`."""
    from open_pandora_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention_bwd, small_attention_bwd_plain)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, N, M, H, D, dtype, causal): the training step's attn1 sites at
    # batch 1 (b*t = 16 frames), attn1 of a 576x1024 training step at
    # levels 0-2, a causal N < M with a ragged M, the narrow model's sites
    # in fp32, the training step's attn1 sites in fp32 (phase 6b)
    flash_cases = [
        (16, 2560, 2560, 5, 64, bf16, False),
        (16, 640, 640, 10, 64, bf16, False),
        (16, 9216, 9216, 5, 64, bf16, False),
        (16, 2304, 2304, 10, 64, bf16, False),
        (16, 576, 576, 20, 64, bf16, False),
        (2, 1000, 1100, 4, 128, bf16, True),
        (2, 1000, 1100, 4, 128, f32, True),
        (16, 2560, 2560, 2, 32, f32, False),
        (16, 640, 640, 4, 32, f32, False),
        (16, 2560, 2560, 5, 64, f32, False),
        (16, 640, 640, 10, 64, f32, False),
        (2, 1100, 1000, 2, 72, f32, True),      # D % 64 != 0, N > M
        (2, 700, 300, 3, 64, f32, False, "offset1"),
    ]
    # the temporal sites at batch 1 (b*h*w positions, t = 16): 40x64,
    # 20x32, 10x16, 5x8 and init_attn; at 576x1024, 72x128, 36x64 and
    # 18x32; ragged N = M = 7 and N < M, the k16 tail (D = 72), q, k, v as
    # strided views of one packed projection; D = 36 and a q off 16-byte
    # alignment (the scalar kernel); the narrow model's in fp32, the five
    # batch-1 sites in fp32 (phase 6b), and the fp32 kernel's edges (N = M
    # = 7, N < M, D = 36 and 72, q 4 bytes off 16-byte alignment)
    small_cases = [
        (2560, 16, 16, 5, 64, bf16),
        (640, 16, 16, 10, 64, bf16),
        (160, 16, 16, 20, 64, bf16),
        (40, 16, 16, 20, 64, bf16),
        (2560, 16, 16, 8, 64, bf16),
        (9216, 16, 16, 5, 64, bf16),
        (2304, 16, 16, 10, 64, bf16),
        (576, 16, 16, 20, 64, bf16),
        (300, 7, 7, 3, 48, bf16),
        (100, 7, 16, 3, 48, bf16),
        (300, 16, 16, 4, 72, bf16),
        (2560, 16, 16, 5, 64, bf16, "packed"),
        (300, 16, 16, 4, 36, bf16),
        (2560, 16, 16, 5, 64, bf16, "offset"),
        (2560, 16, 16, 2, 32, f32),
        (2560, 16, 16, 8, 32, f32),
        (2560, 16, 16, 5, 64, f32),
        (640, 16, 16, 10, 64, f32),
        (160, 16, 16, 20, 64, f32),
        (40, 16, 16, 20, 64, f32),
        (2560, 16, 16, 8, 64, f32),
        (300, 7, 7, 3, 48, f32),
        (100, 7, 16, 3, 48, f32),
        (300, 16, 16, 4, 36, f32),
        (300, 16, 16, 4, 72, f32),
        (2560, 16, 16, 5, 64, f32, "offset1"),
    ]
    if dtypes is not None:
        flash_cases = [c for c in flash_cases if c[5] in dtypes]
        small_cases = [c for c in small_cases if c[5] in dtypes]

    def rnd(*shape, dt):
        return torch.randn(*shape, generator=gen, device=device).to(dt)

    def hold(name, case, kern, plain, ref32_fn, library, work,
             ref64_fn=None):
        outs = kern()
        torch.cuda.synchronize()
        ref32, plain_out = ref32_fn(), plain()
        ref64 = ref64_fn() if ref64_fn else (None,) * 3
        errs, ok = {}, True
        for part, out, p, r, r64 in zip(("dq", "dk", "dv"), outs, plain_out,
                                        ref32, ref64):
            err, bound = _kernel_bound(out, p, r)
            errs[part] = {"max_abs_err": err, "bound": bound}
            ok = ok and bool(np.isfinite(err) and err <= bound)
            if r64 is not None:
                err64, bound64 = _ref64_bound(out, r, r64)
                errs[part].update(ref64_max_abs_err=err64,
                                  ref64_bound=bound64)
                ok = ok and err64 <= bound64
        del outs, ref32, plain_out, ref64
        times = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                 "library_ms": cuda_ms(library)}
        _record(summary, name, {**case, **errs}, max(
            e["max_abs_err"] for e in errs.values()), ok, times, work)

    def sdpa_fwd_bwd(q, k, v, do, mask):
        def call():
            qs, ks, vs = (t.detach().requires_grad_()
                          for t in _sdpa_views(q, k, v))
            out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
            torch.autograd.grad(out, (qs, ks, vs), do.transpose(1, 2))
        return call

    for B, N, M, H, D, dt, causal, *layout in flash_cases:
        q, k, v = _attention_qkv(lambda *s: rnd(*s, dt=dt), B, N, M, H, D,
                                 layout[0] if layout else None)
        do = rnd(B, N, H, D, dt=dt)
        # the plain versions by batch slices of at most about 4 GB of fp32
        # scores: (16, 9216, 9216, 5 heads) is 27 GB in one piece
        chunk = max(1, int(1e9 // (H * N * M)))
        fwd = functools.partial(flash_attention_plain, causal=causal)
        bwd = functools.partial(flash_attention_bwd_plain, causal=causal)
        o, lse = _by_batch(fwd, chunk)(q, k, v)
        args = (q, k, v, o, lse, do)
        pairs = attention_pairs(N, M, causal)
        nbytes = (4 * B * N + 4 * B * M) * H * D * q.element_size() \
            + B * H * N * 4
        mask = _sdpa_mask(N, M, causal, device)
        qs, ks, vs = _sdpa_views(q, k, v)
        # SDPA's forward alone, so that the backward's own gap reads as
        # library_ms - sdpa_fwd_ms
        sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=mask))
        hold("flash_bwd",
             {"shape": [B, N, H, D], "M": M,
              "dtype": str(dt).replace("torch.", ""), "causal": causal,
              **({"layout": layout[0]} if layout else {}),
              "sdpa_fwd_ms": sdpa_fwd},
             lambda: flash_attention_bwd(*args, causal=causal),
             lambda: _by_batch(bwd, chunk)(*args),
             lambda: _by_batch(bwd, chunk)(*[t.float() for t in args]),
             sdpa_fwd_bwd(q, k, v, do, mask),
             (nbytes, 10 * B * H * pairs * D, dt),
             (lambda: _by_batch(bwd, _ref64_chunk(H, N, M))(
                 *[t.double() for t in args])) if dt == f32 else None)
        del q, k, v, do, o, lse, args, qs, ks, vs

    for B, N, M, H, D, dt, *layout in small_cases:
        layout = layout[0] if layout else None
        q, k, v = _attention_qkv(lambda *s: rnd(*s, dt=dt), B, N, M, H, D,
                             layout)
        do = rnd(B, N, H, D, dt=dt)
        args = (q, k, v, do)
        hold("small_attn_bwd",
             {"shape": [B, N, H, D], "M": M,
              "dtype": str(dt).replace("torch.", ""),
              **({"layout": layout} if layout else {})},
             lambda: small_attention_bwd(*args),
             lambda: small_attention_bwd_plain(*args),
             lambda: small_attention_bwd_plain(*[t.float() for t in args]),
             sdpa_fwd_bwd(q, k, v, do, None),
             ((3 * N + 4 * M) * B * H * D * q.element_size(),
              10 * B * H * N * M * D, dt),
             (lambda: small_attention_bwd_plain(
                 *[t.double() for t in args])) if dt == f32 else None)
        del q, k, v, do, args


def _by_batch(fn, chunk: int):
    """fn applied to batch slices of `chunk` samples, results concatenated
    (each part of a tuple on its own): the plain versions hold the
    (B, H, N, M) scores in fp32, which at (32, 9216, 9216, 5 heads) is
    54 GB in one piece."""
    def run(*tensors):
        b = tensors[0].shape[0]
        parts = [fn(*[t[i:i + chunk] for t in tensors])
                 for i in range(0, b, chunk)]
        if isinstance(parts[0], tuple):
            return tuple(torch.cat(p) for p in zip(*parts))
        return torch.cat(parts)
    return run


def check_packed(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention, packed_attention_plain, packed_regime)

    bf16 = torch.bfloat16
    # (B, N, H, D, key rows per stream, gate, dtype); attn1 and attn2 of
    # the spatial transformers at 320x512 (2560, 640 tokens) and 576x1024
    # (9216, 2304, 576), then ragged cases. The regime names the kernel's
    # row: "multi" where the TPU needs its online-softmax kernel.
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
        (32, 2304, 10, 64, (2304,), 1.0, bf16),  # 576x1024, level 1
        (32, 576, 20, 64, (576,), 1.0, bf16),    # level 2
        (32, 9216, 5, 64, (77, 16), 1.0, bf16),  # attn2 at level 0
        (32, 2304, 10, 64, (77, 16), 1.0, bf16),
        (32, 576, 20, 64, (77, 16), 1.0, bf16),
        # the long-key regime: level 0 at 576x1024; a ragged stream whose M
        # is a multiple of neither 64 nor 1024; head widths 32 and 128
        (32, 9216, 5, 64, (9216,), 1.0, bf16),
        (2, 1100, 10, 64, (3000,), 1.0, bf16),
        (2, 1000, 4, 32, (3000,), 1.0, bf16),
        (2, 1000, 2, 128, (2700,), 1.0, bf16),
        (2, 1000, 5, 64, (16,), 1.0, bf16),      # M = 16, N off the q tile
    ]
    for B, N, H, D, ms, gate, dt in cases:
        hd = H * D
        multi = packed_regime(N, ms, H) == "multi"

        def rnd(rows):
            return torch.randn(B, rows, hd, generator=gen,
                               device=device).to(dt)
        q = rnd(N)
        streams = [(rnd(m), rnd(m)) for m in ms]
        flat = [t for kv in streams for t in kv]
        # the gate as the model hands it: a float, or a tensor when learnable
        g = gate if gate == 1.0 else torch.tensor(gate, device=device)
        library = None
        if len(ms) == 1 and gate == 1.0:   # one stream: plain attention
            qs, ks, vs = _heads_first(q.view(B, N, H, D),
                                      *(t.view(B, ms[0], H, D)
                                        for t in streams[0]))

            def library():
                return F.scaled_dot_product_attention(qs, ks, vs)

        timed = None
        if len(ms) == 2:   # text + image streams: row 8's eager chain
            views = [t.view(B, -1, H, D) for t in [q] + [
                t for kv in streams for t in kv]]
            timed = {"eager_ms": lambda: dual_cross_eager(*views, g)}

        def plain(q, *kv):
            return packed_attention_plain(q, list(zip(kv[::2], kv[1::2])), g,
                                          heads=H)
        # at most about 4 GB of fp32 scores per slice
        plain = _by_batch(plain, max(1, int(1e9 // (H * N * sum(ms)))))
        _check(summary, "packed_multi" if multi else "packed_attn_fwd",
               {"shape": [B, N, H, D], "M": list(ms), "gate": gate,
                "dtype": str(dt).replace("torch.", "")},
               lambda: packed_attention(q, streams, g, heads=H),
               lambda: plain(q, *flat),
               lambda: plain(q.float(), *[t.float() for t in flat]),
               ((2 * N + 2 * sum(ms)) * B * hd * 2,
                4 * B * N * sum(ms) * hd, dt), library, timed)
        del q, streams, flat, library, timed


def dual_cross_eager(q, kt, vt, ki, vi, gate):
    """Row 8's function as a chain of PyTorch calls: SDPA on the
    (B, H, N, D) views of each stream, the gated sum. A yardstick timed
    beside the kernel (`eager_ms`); never routed to."""
    qs = q.transpose(1, 2)
    text = F.scaled_dot_product_attention(qs, *_heads_first(kt, vt))
    image = F.scaled_dot_product_attention(qs, *_heads_first(ki, vi))
    return (text + gate * image).transpose(1, 2)


# (B, N, H, D, (text keys, image keys), gate) of row 8: attn2 at head width
# 80 (phase 5b: 320 and 640 channels at 320x512), a learnable gate, a ragged
# N with both streams off the tile, head width 48 (phase 4), and level 0 at
# 576x1024; then streams too long to stay on chip (512 keys each, the
# gate's most), and a head width with a k16 tail (40)
DUAL_CROSS_CASES = [
    (32, 2560, 4, 80, (77, 16), 1.0),
    (32, 640, 8, 80, (77, 16), 1.0),
    (32, 2560, 4, 80, (77, 16), 1.37),
    (2, 1000, 3, 48, (100, 130), 0.25),
    (32, 2560, 2, 48, (77, 16), 1.0),
    (32, 640, 4, 48, (77, 16), 0.6),
    (32, 9216, 4, 80, (77, 16), 1.0),
    (2, 600, 2, 128, (512, 512), 0.8),
    (4, 700, 3, 40, (77, 16), 1.0),
]


def check_dual_cross(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.dual_cross_attention import (
        dual_cross_attention, dual_cross_attention_plain, launch_plan)

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for B, N, H, D, ms, gate in DUAL_CROSS_CASES:
        def rnd(rows):
            # views of packed (B, rows, H*D) projections, as the UNet has
            return torch.randn(B, rows, H * D, generator=gen, device=device
                               ).to(torch.bfloat16).view(B, rows, H, D)
        ts = [rnd(N)] + [rnd(m) for m in ms for _ in range(2)]
        g = gate if gate == 1.0 else torch.tensor(gate, device=device)
        plan = launch_plan(B, N, H, D, *ms, sms)
        _check(summary, "dual_cross",
               {"shape": [B, N, H, D], "M": list(ms), "gate": gate,
                "dtype": "bfloat16", "resident": plan.resident,
                "grid": list(plan.grid)},
               lambda: dual_cross_attention(*ts, g),
               lambda: dual_cross_attention_plain(*ts, g),
               lambda: dual_cross_attention_plain(*[t.float() for t in ts],
                                                  g),
               ((2 * N + 2 * sum(ms)) * B * H * D * 2,
                4 * B * N * sum(ms) * H * D, torch.bfloat16),
               timed={"eager_ms": lambda: dual_cross_eager(*ts, g)})
        del ts


def check_refusals(device) -> None:
    """Shapes a gate refuses must raise in the wrapper on the card: the
    fused temporal kernel at head widths 80 and 48 (its mma tiles serve 16,
    32 and 64), the packed and dual cross-attention kernels at a head width
    that is no multiple of 8, the conv kernel at a channel count that is no
    multiple of 8 and the GEGLU kernel at a width that is no multiple of
    32. The packed and dual cross-attention wrappers must also refuse rows
    that are 4-byte but not 16-byte aligned, a view their gates (shapes
    only) admit."""
    from open_pandora_tpu_torch.ops.dual_cross_attention import (
        dual_cross_attention, dual_cross_attention_eligible)
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_eligible, fused_temporal_self_attention)
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention_eligible, self_attention_packed)

    def refused(gate_says, call):
        try:
            call()
        except ValueError:
            return not gate_says
        return False

    def temporal(c, heads):
        y = torch.zeros(2, 16, 64, c, dtype=torch.bfloat16, device=device)
        w = torch.zeros(c, c, dtype=torch.bfloat16, device=device)
        return lambda: fused_temporal_self_attention(
            y, w, w, w, w, w[0], w[0], w[0], heads=heads)

    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.ops.conv2d import (conv3x3_eligible,
                                                   conv3x3_nhwc)
    from open_pandora_tpu_torch.ops.fused_geglu import (fused_geglu_ff,
                                                        geglu_ff_eligible)

    def geglu(c):
        z = functools.partial(torch.zeros, dtype=torch.bfloat16,
                              device=device)
        return lambda: fused_geglu_ff(z(64, c), z(c), z(c), z(c, 8 * c),
                                      z(8 * c), z(4 * c, c), z(c))

    x = torch.zeros(2, 600, 2, 44, dtype=torch.bfloat16, device=device)
    # packed rows that are 4-byte but not 16-byte aligned: 2 elements into
    # rows of 130, a shape the gate admits
    xa = torch.zeros(2, 600, 130, dtype=torch.bfloat16,
                     device=device)[:, :, 2:]
    with flags.overridden(ENABLE_PCONV=True):
        conv_c12 = conv3x3_eligible(40, 64, 12, 320)
    results = {
        "fused_temporal_d80": refused(
            fused_temporal_eligible(16, 320, 320, 4), temporal(320, 4)),
        "fused_temporal_d48": refused(
            fused_temporal_eligible(16, 96, 96, 2), temporal(96, 2)),
        "packed_d44": refused(
            packed_attention_eligible(600, (600,), 2, 88),
            lambda: self_attention_packed(*[x.view(2, 600, 88)] * 3,
                                          heads=2)),
        "packed_align4": refused(
            not packed_attention_eligible(600, (600,), 2, 128),
            lambda: self_attention_packed(xa, xa, xa, heads=2)),
        "dual_cross_d44": refused(
            dual_cross_attention_eligible(600, 600, 600, 44),
            lambda: dual_cross_attention(x, x, x, x, x, 1.0)),
        # the same 4-byte-aligned rows as two heads of 64, the streams 77
        # and 16 of them
        "dual_cross_align4": refused(
            not dual_cross_attention_eligible(600, 77, 16, 64),
            lambda: dual_cross_attention(
                xa.view(2, 600, 2, 64), *[xa[:, :m].view(2, m, 2, 64)
                                          for m in (77, 77, 16, 16)], 1.0)),
        # a channel count that is no multiple of 8, and a GEGLU width
        # that is no multiple of 32
        "conv3x3_c12": refused(conv_c12, lambda: conv3x3_nhwc(
            torch.zeros(2, 40, 64, 12, dtype=torch.bfloat16, device=device),
            torch.zeros(3, 3, 12, 320, dtype=torch.bfloat16,
                        device=device))),
        "fused_geglu_c48": refused(geglu_ff_eligible(48), geglu(48)),
    }
    log("kernels", json.dumps({"refused_by_gate_and_wrapper": results}))
    if not all(results.values()):
        raise AssertionError(f"a refused shape launched: {results}")


# (shape, heads) of row 4: every site PandoraConfig()'s UNet hands the
# kernel at 320x512 (level 0, level 1, init_attn), then at 576x1024
# (tests/test_torch_gn_ft_plans.py holds the list to a meta trace of the
# UNet); then the edges of the tensor-core route (a ragged last tile at
# 320 and 640 channels, fewer positions than one tile, a 3-D (B, t, c)
# stream) and the shapes left on the mma.sync kernel (head widths 32 and
# 16: the narrow model; t = 8)
FUSED_TEMPORAL_CASES = [
    ((2, 16, 2560, 320), 5),
    ((2, 16, 640, 640), 10),
    ((2, 16, 2560, 512), 8),
    ((2, 16, 9216, 320), 5),
    ((2, 16, 2304, 640), 10),
    ((2, 16, 9216, 512), 8),
    ((2, 16, 37, 320), 5),
    ((2, 16, 37, 640), 10),
    ((1, 16, 3, 512), 8),
    ((100, 16, 640), 10),
    ((2, 16, 2560, 64), 2),
    ((2, 16, 2560, 256), 8),
    ((2, 16, 640, 128), 4),
    ((2, 16, 100, 64), 4),
    ((2, 8, 100, 320), 5),
]


def fused_temporal_eager(y, wq, wk, wv, wo, bo, ln_w, ln_b, *, heads,
                         eps=1e-5):
    """Row 4's function as a chain of PyTorch calls: F.layer_norm, three
    F.linear, SDPA over t, F.linear with the bias, the residual. A
    yardstick timed beside the kernel (`eager_ms`); never routed to."""
    c = y.shape[-1]
    dh = c // heads
    xn = F.layer_norm(y, (c,), ln_w, ln_b, eps)

    def split(z):                     # -> (positions, heads, t, dh)
        if z.ndim == 4:
            b, t, hw, _ = z.shape
            return z.view(b, t, hw, heads, dh).permute(0, 2, 3, 1, 4) \
                .flatten(0, 1)
        return z.view(*z.shape[:2], heads, dh).transpose(1, 2)
    q, k, v = (split(F.linear(xn, w)) for w in (wq, wk, wv))
    o = F.scaled_dot_product_attention(q, k, v)
    if y.ndim == 4:
        b, t, hw, _ = y.shape
        o = o.view(b, hw, heads, t, dh).permute(0, 3, 1, 2, 4)
    else:
        o = o.transpose(1, 2)
    return F.linear(o.reshape(y.shape), wo, bo) + y


def check_fused_temporal(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_plain, fused_temporal_self_attention,
        tensor_core_route)

    for shape, heads in FUSED_TEMPORAL_CASES:
        y, params = fused_temporal_inputs(shape, gen, device)
        c, t = shape[-1], shape[1]
        rows = y.numel() // c
        route = ("wgmma" if tensor_core_route(y, params[5], params[6], heads)
                 else "mma")
        # LN, four c x c projections, the t x t attention of every row
        _check(summary, "fused_temporal_attn",
               {"shape": list(shape), "heads": heads, "route": route,
                "dtype": "bfloat16"},
               lambda: fused_temporal_self_attention(y, *params, heads=heads),
               lambda: fused_temporal_plain(y, *params, heads=heads),
               lambda: fused_temporal_plain(
                   y.float(), *[p.float() for p in params], heads=heads),
               ((2 * y.numel() + 4 * c * c + 3 * c) * 2,
                8 * rows * c * c + 4 * rows * t * c, torch.bfloat16),
               timed={"eager_ms": lambda: fused_temporal_eager(
                   y, *params, heads=heads)})
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


def unet_group_norms(hz: int, wz: int) -> list:
    """(shape, eps, silu) of every GroupNorm site of PandoraConfig()'s UNet
    at latent size hz x wz (levels hz >> i, wz >> i; tests/
    test_torch_gn_ft_plans.py holds the list to a meta trace): per level the
    temporal conv blocks and temporal-transformer norms on (2, 16, h, w,
    C) slabs and the ResBlocks, decoder concats and spatial-transformer
    norms on (32, h, w, C); transformer norms at eps 1e-6 without SiLU,
    the rest at 1e-5 with it."""
    (a0, b0), (a1, b1), (a2, b2), (a3, b3) = [(hz >> i, wz >> i)
                                              for i in range(4)]
    both = [(2, 16, a0, b0, 320), (2, 16, a1, b1, 640), (2, 16, a2, b2, 1280),
            (2, 16, a3, b3, 1280), (32, a3, b3, 1280), (32, a2, b2, 1280),
            (32, a1, b1, 640), (32, a0, b0, 320)]
    silu_only = [(32, a3, b3, 2560), (32, a2, b2, 640), (32, a2, b2, 1920),
                 (32, a2, b2, 2560), (32, a1, b1, 320), (32, a1, b1, 960),
                 (32, a1, b1, 1280), (32, a1, b1, 1920), (32, a0, b0, 640),
                 (32, a0, b0, 960)]
    return ([(s, 1e-6, False) for s in both]
            + [(s, 1e-5, True) for s in both + silu_only])


def group_norm_cases() -> list:
    """(shape, eps, silu) of phase 3's row-5 cases: the UNet's sites at
    320x512 and 576x1024, the VAE's, then the edges of the launch plan: a
    single sample, a ragged slab with 3 channels a group, a ragged last
    block of either pass, and fewer rows than pass-1 blocks a sample."""
    edges = [((32, 1027, 320), 1e-5, True), ((32, 3, 320), 1e-5, True)]
    # the headline case first: it is the kernels line's record
    first = ((32, 40, 64, 320), 1e-5, True)
    unet = [cs for cs in unet_group_norms(40, 64) if cs != first]
    return ([first] + unet + unet_group_norms(72, 128) + [
        ((8, 320, 512, 128), 1e-6, True),       # VAE decode, 21M / sample
        ((8, 320, 512, 256), 1e-6, True),
        ((8, 40, 64, 512), 1e-6, False),        # VAE mid attention norm
        ((1, 320, 512, 128), 1e-6, True),       # VAE encode
        ((2, 576, 1024, 128), 1e-6, True),      # 576x1024 decode chunk
        ((1, 576, 1024, 128), 1e-6, True),      # 576x1024 encode
        ((1, 40, 64, 320), 1e-5, True),         # N = 1
        ((3, 1000, 96), 1e-5, True),            # ragged, 3 channels a group
    ] + edges)


def check_group_norm(summary: dict, device, gen) -> None:
    from open_pandora_tpu_torch.ops.fused_norms import (
        fused_group_norm_silu, launch_plan)
    from open_pandora_tpu_torch.ops.norms import group_norm

    for shape, eps, silu in group_norm_cases():
        c = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=device) * 3.0
             + 0.5).to(torch.bfloat16)
        w = (1.0 + 0.1 * torch.randn(c, generator=gen, device=device)
             ).to(torch.bfloat16)
        b = (0.05 * torch.randn(c, generator=gen, device=device)
             ).to(torch.bfloat16)
        kw = dict(num_groups=32, eps=eps, silu=silu)
        plan = launch_plan(shape[0], x.numel() // (shape[0] * c), c)
        # without SiLU one PyTorch call computes the same function: the
        # library yardstick, on the channel-first view
        xt = x.movedim(-1, 1)
        # statistics, normalise, scale, shift, SiLU: about 8 per element
        _check(summary, "group_norm_silu",
               {"shape": list(shape), "eps": eps, "silu": silu,
                "splits": plan.splits, "chunks": plan.chunks,
                "dtype": "bfloat16"},
               lambda: fused_group_norm_silu(x, w, b, **kw),
               lambda: group_norm(x, w, b, **kw),
               lambda: group_norm(x.float(), w.float(), b.float(), **kw),
               ((2 * x.numel() + 2 * c) * 2, 8 * x.numel(), torch.bfloat16),
               None if silu else lambda: F.group_norm(xt, 32, w, b, eps))
        del xt
        del x, w, b


def routed_conv_shapes() -> list:
    """The distinct (h, w, c, co) that the opt-in conv routes take in
    PandoraConfig()'s UNet at 320x512, then those at 576x1024 (the gates
    admit the same sites under either flag)."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.ops.conv2d import conv3x3_eligible

    u = PandoraConfig().unet
    shapes = []
    with flags.overridden(ENABLE_PCONV=True):
        for hz, wz in ((40, 64), (72, 128)):
            for _, *site in conv_sites(u, hz, wz):
                if conv3x3_eligible(*site) and tuple(site) not in shapes:
                    shapes.append(tuple(site))
    return shapes


def routed_conv_cases() -> list:
    """(h, w, c, co, variant) of every routed conv site of PandoraConfig()'s
    UNet at 320x512, then at 576x1024, once for each variant a route takes
    there: "plain" (row 11, PANDORA_ENABLE_PCONV) at every site; under
    PANDORA_ENABLE_PCONV2 (row 12) "none" at the input and Upsample convs,
    "pro" at a ResBlock's first conv (its GroupNorm folded in) and
    "pro_res" at its second (its skip added too)."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.ops.conv2d import conv3x3_eligible

    u = PandoraConfig().unet
    cases = []
    with flags.overridden(ENABLE_PCONV=True):
        for hz, wz in ((40, 64), (72, 128)):
            n_res = 0
            for kind, *site in conv_sites(u, hz, wz):
                variant = "none"
                if kind == "res":           # the sites come in pairs
                    variant = ("pro", "pro_res")[n_res % 2]
                    n_res += 1
                if not conv3x3_eligible(*site):
                    continue
                for v in ("plain", variant):
                    if (*site, v) not in cases:
                        cases.append((*site, v))
    return cases


def check_conv(summary: dict, device, gen, dtypes=None) -> None:
    """Rows 11 and 12 at every routed conv site of the product UNet at
    320x512 and 576x1024 (B = 32: a CFG pair of 16 frames), the most
    frequent level-0 site first: in bf16 row 11 plain and row 12 with the
    prologue, with the prologue and the residual, and with neither; then a
    ragged slab (h, w and Co off the tiles), fp32 at B = 2 and its edges
    (a ragged slab, C = 24 below one 32-channel chunk, C = 40 with a
    ragged one), and row 12 at an edge-heavy shift in both dtypes (a
    prologue applied to the zero border would show there); then fp32 at
    every routed site, each in the variants the routes take there
    (`routed_conv_cases`). Every fp32 case is held to the ref64 rule too.
    The library yardstick is cuDNN's conv of the same slab with its bias
    (for row 12 the conv alone), in fp32 with TF32 off; fp32 cases also
    time it with TF32 on (`library_tf32_ms`: one TF32 pass, context only).
    Also the gate's refusal at 10x16. `dtypes`: only the cases in those."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.ops.conv2d import (conv3x3_eligible,
                                                   conv3x3_fused,
                                                   conv3x3_fused_eligible,
                                                   conv3x3_fused_plain,
                                                   conv3x3_nhwc, pack_weight)

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = sorted(routed_conv_shapes(),
                    key=lambda s: s != (40, 64, 320, 320))
    cases = [(32, *s, bf16, v, 0.0) for v in ("plain", "pro", "pro_res",
                                               "none") for s in shapes]
    cases += [(3, 37, 45, 64, 72, bf16, "plain", 0.0),
              (3, 37, 45, 64, 72, bf16, "pro_res", 0.0),
              (2, 40, 64, 320, 320, f32, "plain", 0.0),
              (2, 40, 64, 320, 320, f32, "pro_res", 0.0),
              (3, 37, 45, 64, 72, f32, "pro_res", 0.0),
              (2, 20, 32, 24, 64, f32, "pro", 0.0),
              (2, 16, 24, 40, 48, f32, "pro_res", 0.0),
              (2, 40, 64, 320, 320, bf16, "pro_res", 5.0),
              (2, 40, 64, 320, 320, f32, "pro_res", 5.0)]
    cases += [(32, h, w, c, co, f32, v, 0.0)
              for h, w, c, co, v in routed_conv_cases()]
    cases = [c for c in cases if dtypes is None or c[5] in dtypes]

    def rnd(*shape, dt=f32, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + shift).to(dt)

    def d64(t):
        return None if t is None else t.double()
    for B, H, W, C, Co, dt, variant, shift in cases:
        x = rnd(B, H, W, C, dt=dt)
        w = rnd(3, 3, C, Co, dt=dt, scale=(9 * C) ** -0.5)
        b = rnd(Co, scale=0.1)
        pro = variant.startswith("pro")
        a = rnd(B, C, scale=0.1, shift=1.0) if pro else None
        sh = rnd(B, C, scale=0.5, shift=shift) if pro else None
        r = rnd(B, H, W, Co, dt=dt) if variant == "pro_res" else None
        packed = pack_weight(w, dt)
        if variant == "plain":
            name = "conv3x3"

            def kern():
                return conv3x3_nhwc(x, w, b, packed=packed)
        else:
            name = "conv3x3_fused"

            def kern():
                return conv3x3_fused(x, w, b, a, sh, r, packed=packed)
        xc = x.permute(0, 3, 1, 2)
        wc = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bc = b.to(dt)

        def cudnn():
            return F.conv2d(xc, wc, bc, padding=1)

        def cudnn_tf32():
            torch.backends.cudnn.allow_tf32 = True
            try:
                return cudnn()
            finally:
                torch.backends.cudnn.allow_tf32 = False
        fp32 = dt == f32
        m = B * H * W
        nbytes = ((x.numel() + 9 * C * Co + m * Co
                   + (m * Co if r is not None else 0)) * x.element_size()
                  + (2 * B * C if pro else 0) * 4 + Co * 4)
        library = "cuDNN conv + bias" + (" (no prologue or residual)"
                                         if name != "conv3x3" else "")
        _check(summary, name,
               {"shape": [B, H, W, C], "Co": Co, "variant": variant,
                "shift": shift, "dtype": str(dt).replace("torch.", ""),
                "library": library,
                **({"library_tf32": library + " with TF32 on: one TF32 "
                    "pass, context only"} if fp32 else {})},
               kern, lambda: conv3x3_fused_plain(x, w, b, a, sh, r),
               lambda: conv3x3_fused_plain(
                   x.float(), w.float(), b, a, sh,
                   None if r is None else r.float()),
               (nbytes, 2 * m * Co * 9 * C, dt), cudnn,
               timed={"library_tf32_ms": cudnn_tf32} if fp32 else None,
               ref64_fn=(lambda: conv3x3_fused_plain(
                   x.double(), w.double(), b.double(), d64(a), d64(sh),
                   d64(r))) if fp32 else None)
        del x, w, b, a, sh, r, packed, xc, wc, bc
    with flags.overridden(ENABLE_PCONV=True, ENABLE_PCONV2=True):
        refusal = {"10x16x1280x1280": not conv3x3_eligible(10, 16, 1280, 1280)
                   and not conv3x3_fused_eligible(10, 16, 1280, 1280)}
    log("kernels", json.dumps({"conv_gate_refuses": refusal}))
    if not all(refusal.values()):
        raise AssertionError(f"the conv gates admit {refusal}")


def geglu_eager(x, g, b, w1, b1, w2, b2, eps=1e-5):
    """Row 13's function as a chain of PyTorch calls in x's dtype:
    F.layer_norm, F.linear with W1 and b1, v * F.gelu(g), F.linear with W2
    and b2, the residual. A yardstick timed beside the kernels
    (`eager_ms`); never routed to."""
    c = x.shape[-1]
    v, gate = F.linear(F.layer_norm(x, (c,), g, b, eps), w1.t(),
                       b1).chunk(2, dim=-1)
    return F.linear(v * F.gelu(gate), w2.t(), b2) + x


# (rows, c, dtype) of row 13: the UNet's feed-forward widths (320, 640,
# 1280 at the rows of the spatial transformers at 320x512, 294912 at
# 576x1024 level 0), ragged row counts, a width past the UNet's that the
# JAX gate admits (1920), in bf16 and in fp32
GEGLU_SHAPES = [(81920, 320), (20480, 640), (5120, 1280), (294912, 320),
                (1000, 320), (77, 1280), (5120, 1920)]
GEGLU_CASES = ([(r, c, torch.bfloat16) for r, c in GEGLU_SHAPES]
               + [(4096, 640, torch.float32)]
               + [(r, c, torch.float32) for r, c in GEGLU_SHAPES])
# the x each UNet feed-forward site hands row 13 on the bf16 eval route
# (batched CFG, 16 frames), by the layout the eager chain would chunk it
# in: spatial (b t, h w, c), native temporal (b, t, h w, c), transposed
# temporal (b h w, t, c) at 1280 channels; init_attn 512 wide. 320x512 (a
# 40x64 latent), then 576x1024 (72x128)
GEGLU_SITES = [
    ("spatial", (32, 2560, 320)), ("temporal", (2, 16, 2560, 320)),
    ("spatial", (32, 640, 640)), ("temporal", (2, 16, 640, 640)),
    ("spatial", (32, 160, 1280)), ("temporal", (320, 16, 1280)),
    ("spatial", (32, 40, 1280)), ("temporal", (80, 16, 1280)),
    ("init_attn", (2, 16, 2560, 512)),
    ("spatial", (32, 9216, 320)), ("temporal", (2, 16, 9216, 320)),
    ("spatial", (32, 2304, 640)), ("temporal", (2, 16, 2304, 640)),
    ("spatial", (32, 576, 1280)), ("temporal", (1152, 16, 1280)),
    ("spatial", (32, 144, 1280)), ("temporal", (288, 16, 1280)),
    ("init_attn", (2, 16, 9216, 512))]


def geglu_ref64(args, rows: int = 65536):
    """The plain version in float64 on the same inputs, by slices of
    `rows` rows (its gated rows are 16 inner bytes a row)."""
    from open_pandora_tpu_torch.ops.fused_geglu import geglu_ff_plain
    x, *rest = [t.double() for t in args]
    return torch.cat([geglu_ff_plain(x[i:i + rows], *rest)
                      for i in range(0, x.shape[0], rows)])


def geglu_port_eager(x, g, b, w1, b1, w2, b2, eps=1e-5):
    """The chain the port's UNet runs off the fused route, x + ff(norm3(x)):
    `models.layers.LayerNorm` (ops/norms.layer_norm, fp32 statistics), the
    GEGLU, the Linear and the residual, in chunks of x's leading axis as
    `FeedForward.chunks` takes them; weights in row 13's layout. Returns
    the call."""
    from open_pandora_tpu_torch.models.layers import LayerNorm
    from open_pandora_tpu_torch.models.unet3d import FeedForward
    c = x.shape[-1]
    with torch.device("meta"):
        ff, norm = FeedForward(c, mult=w2.shape[0] // c), LayerNorm(c, eps)
    ff.to_empty(device=x.device).to(x.dtype).eval()
    norm.to_empty(device=x.device).to(x.dtype)
    with torch.no_grad():
        for p, v in ((ff.net[0].proj.weight, w1.t()),
                     (ff.net[0].proj.bias, b1), (ff.net[2].weight, w2.t()),
                     (ff.net[2].bias, b2), (norm.weight, g),
                     (norm.bias, b)):
            p.copy_(v)

    def run():
        with torch.no_grad():
            return x + ff(norm(x))
    return run


def check_geglu(summary: dict, device, gen, dtypes=None) -> None:
    """Row 13 at GEGLU_CASES. No single PyTorch call computes it; the
    yardstick is its eager chain (`eager_ms`), in fp32 with TF32 off and,
    for context, on (`eager_tf32_ms`: one TF32 pass). Every fp32 case is
    held to the ref64 rule too. `dtypes`: only the cases in those. With
    bf16, also every UNet site of GEGLU_SITES against the port's own eager
    chain (`port_eager_ms`, chunked as the UNet chunks it off the fused
    route): the A/B that routes row 13 by default."""
    from open_pandora_tpu_torch.ops.fused_geglu import (fused_geglu_ff,
                                                        geglu_ff_plain)

    def rnd(*shape, dt, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + shift).to(dt)
    for R, c, dt in GEGLU_CASES:
        if dtypes is not None and dt not in dtypes:
            continue
        inner = 4 * c
        args = (rnd(R, c, dt=dt, scale=3.0),
                rnd(c, dt=dt, scale=0.1, shift=1.0), rnd(c, dt=dt, scale=0.05),
                rnd(c, 2 * inner, dt=dt, scale=c ** -0.5),
                rnd(2 * inner, dt=dt, scale=0.02),
                rnd(inner, c, dt=dt, scale=inner ** -0.5),
                rnd(c, dt=dt, scale=0.02))
        es = args[0].element_size()
        fp32 = dt == torch.float32
        timed = {"eager_ms": lambda: geglu_eager(*args)}
        if fp32:
            def eager_tf32():
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    return geglu_eager(*args)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
            timed["eager_tf32_ms"] = eager_tf32
        _check(summary, "fused_geglu",
               {"shape": [R, c], "inner": inner,
                "dtype": str(dt).replace("torch.", ""),
                **({"eager_tf32": "the eager chain with matmul TF32 on: one "
                    "TF32 pass, context only"} if fp32 else {})},
               lambda: fused_geglu_ff(*args),
               lambda: geglu_ff_plain(*args),
               lambda: geglu_ff_plain(*[t.float() for t in args]),
               ((2 * R * c + 12 * c * c + 11 * c) * es, 24 * R * c * c, dt),
               timed=timed,
               ref64_fn=(lambda: geglu_ref64(args)) if fp32 else None)
        del args
    if dtypes is not None and torch.bfloat16 not in dtypes:
        return
    dt = torch.bfloat16
    for site, shape in GEGLU_SITES:
        c = shape[-1]
        inner = 4 * c
        args = (rnd(*shape, dt=dt, scale=3.0),
                rnd(c, dt=dt, scale=0.1, shift=1.0), rnd(c, dt=dt, scale=0.05),
                rnd(c, 2 * inner, dt=dt, scale=c ** -0.5),
                rnd(2 * inner, dt=dt, scale=0.02),
                rnd(inner, c, dt=dt, scale=inner ** -0.5),
                rnd(c, dt=dt, scale=0.02))
        R = args[0].numel() // c
        flat = (args[0].reshape(R, c), *args[1:])
        _check(summary, "fused_geglu",
               {"shape": [R, c], "inner": inner, "dtype": "bfloat16",
                "site": site, "x": list(shape)},
               lambda: fused_geglu_ff(*flat),
               lambda: geglu_ff_plain(*flat),
               lambda: geglu_ff_plain(*[t.float() for t in flat]),
               ((2 * R * c + 12 * c * c + 11 * c) * 2, 24 * R * c * c, dt),
               timed={"eager_ms": lambda: geglu_eager(*flat),
                      "port_eager_ms": geglu_port_eager(*args)})
        del args, flat


# SVD-XT's new sites on the bf16 eval route at 576x1024x25 with batched CFG
# (a 72x128 latent, 2 videos of 25 frames): the VideoTransformerBlock's
# ff_in and ff (native (b, t, h w, c)) at levels 0-2 and the middle; its
# self-attention over t = 25 at every level
SVD_GEGLU_SITES = [("video_ff", (2, 25, 9216, 320)),
                   ("video_ff", (2, 25, 2304, 640)),
                   ("video_ff", (2, 25, 576, 1280)),
                   ("video_ff", (2, 25, 144, 1280))]
SVD_TEMPORAL_SITES = [((2, 25, 9216, 320), 5), ((2, 25, 2304, 640), 10)]
SVD_SMALL_CASES = [(18432, 25, 25, 5, 64, torch.bfloat16),
                   (4608, 25, 25, 10, 64, torch.bfloat16),
                   (1152, 25, 25, 20, 64, torch.bfloat16),
                   (288, 25, 25, 20, 64, torch.bfloat16)]


def svd_self_attention_eager(y, params, heads):
    """The port's eager route for a VideoTransformerBlock's x +
    attn1(norm1(x)) over t on y (b, t, s, c): models.svd's transpose to
    (b s, t, c), LayerNorm, CrossAttention (the dispatcher's small-attention
    kernel at t = 25) and the residual. Returns the call."""
    from open_pandora_tpu_torch.models import svd

    c = y.shape[-1]
    with torch.device("meta"):
        blk = svd.VideoTransformerBlock(c, heads, c // heads, 1024)
    blk.to_empty(device=y.device).to(y.dtype).eval()
    wq, wk, wv, wo, bo, ln_w, ln_b = params
    a = blk.attn1
    with torch.no_grad():
        for p_, v in ((a.to_q.weight, wq), (a.to_k.weight, wk),
                      (a.to_v.weight, wv), (a.to_out[0].weight, wo),
                      (a.to_out[0].bias, bo), (blk.norm1.weight, ln_w),
                      (blk.norm1.bias, ln_b)):
            p_.copy_(v)

    def run():
        with torch.no_grad():
            return blk.self_attention(y)
    return run


def check_svd_sites(summary: dict, device, gen) -> None:
    """Phase 3's A/B of SVD-XT's new sites against the port's eager route,
    each routed to an existing kernel only where the kernel wins: row 13 at
    the temporal feed-forwards' widths (`port_eager_ms`: the eager chain,
    chunked as the UNet chunks it); row 4's mma.sync route at t = 25, which
    its gate admits at 320 and 640 channels (`port_eager_ms`: LN,
    projections, the dispatcher's small-attention kernel, residual: the
    route models.svd takes, row 4 having lost here); row 2 at t = 25
    against SDPA."""
    from open_pandora_tpu_torch.ops.fused_geglu import (fused_geglu_ff,
                                                        geglu_ff_plain)
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_plain, fused_temporal_self_attention)
    from open_pandora_tpu_torch.ops.small_attention import (
        small_attention, small_attention_plain)

    dt = torch.bfloat16

    def rnd(*shape, scale=1.0, shift=0.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale
                + shift).to(dt)
    for site, shape in SVD_GEGLU_SITES:
        c = shape[-1]
        inner = 4 * c
        args = (rnd(*shape, scale=3.0), rnd(c, scale=0.1, shift=1.0),
                rnd(c, scale=0.05), rnd(c, 2 * inner, scale=c ** -0.5),
                rnd(2 * inner, scale=0.02), rnd(inner, c, scale=inner ** -0.5),
                rnd(c, scale=0.02))
        R = args[0].numel() // c
        flat = (args[0].reshape(R, c), *args[1:])
        _check(summary, "fused_geglu",
               {"shape": [R, c], "inner": inner, "dtype": "bfloat16",
                "site": site, "x": list(shape)},
               lambda: fused_geglu_ff(*flat),
               lambda: geglu_ff_plain(*flat),
               lambda: geglu_ff_plain(*[t.float() for t in flat]),
               ((2 * R * c + 12 * c * c + 11 * c) * 2, 24 * R * c * c, dt),
               timed={"port_eager_ms": geglu_port_eager(*args)})
        del args, flat
    for shape, heads in SVD_TEMPORAL_SITES:
        y, params = fused_temporal_inputs(shape, gen, device)
        c, t = shape[-1], shape[1]
        rows = y.numel() // c
        _check(summary, "fused_temporal_attn",
               {"shape": list(shape), "heads": heads, "route": "mma",
                "dtype": "bfloat16", "site": "svd_attn1"},
               lambda: fused_temporal_self_attention(y, *params, heads=heads),
               lambda: fused_temporal_plain(y, *params, heads=heads),
               lambda: fused_temporal_plain(
                   y.float(), *[p.float() for p in params], heads=heads),
               ((2 * y.numel() + 4 * c * c + 3 * c) * 2,
                8 * rows * c * c + 4 * rows * t * c, dt),
               timed={"port_eager_ms": svd_self_attention_eager(y, params,
                                                                heads)})
        del y, params
    _check_attention(summary, "small_attn_fwd", small_attention,
                     small_attention_plain, SVD_SMALL_CASES, False, device,
                     gen)


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


def wide_head_narrow_config():
    """narrow_config() at head width 48 (96 and 192 channels, 2 and 4
    heads): a width that does not divide 128, so attn2 takes the dual
    cross-attention kernel, attn1 the flash kernel and every temporal site
    the small-attention kernel."""
    import dataclasses
    cfg = narrow_config()
    return dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, model_channels=96, num_head_channels=48))


def check_model_bf16(device, seed: int, cfg=None, decode: bool = True,
                     must_launch=("packed", "fused_temporal", "group_norm")
                     ) -> None:
    """bf16: one CFG UNet eval and one 8-frame decode chunk on the card (the
    fused route) and on the CPU (the unfused route), each against fp32 on
    the CPU with the same bf16-rounded weights and inputs. The card passes
    where its error is within twice the CPU bf16 route's plus 1% of the
    mean |fp32 value| (the JAX package's fused_selfcheck rule,
    ops/fused_temporal.py:189-238, applied to the model). `cfg` defaults to
    narrow_config(); `decode` False leaves the decode chunk out;
    `must_launch` names kernels the card leg has to run."""
    from open_pandora_tpu_torch.eval.inference import build_model

    cfg = cfg or narrow_config()
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
            frames = (model.decode(z.to(dev, dt), frame_chunk=8) if decode
                      else eps[:0])
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
    report, ok = {"dtype": "bfloat16",
                  "head_width": u.num_head_channels}, True
    for i, part in enumerate(("unet_eval", "decode_chunk")[:1 + decode]):
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
    want = {k: want["per_eval"][k] + decode * want["decode_chunk"][k]
            for k in KERNEL_KEYS}
    report["launches"], report["predicted"] = launches, want
    log("model", json.dumps(report))
    if not ok:
        raise AssertionError("bf16 card route disagrees with fp32 beyond "
                             "the bound")
    if launches != want or min(launches[k] for k in must_launch) <= 0:
        raise AssertionError(f"bf16 card launches {launches} != {want}")


# card against CPU for the narrow WorldModel's conditioning, relative to the
# largest |value|: fp32 on both sides, TF32 off, through a 2-layer tower, the
# clustering (equal indices, so the same tokens are averaged), a 2-layer
# trunk and a 2-layer Q-Former; summation order only
WORLD_BOUND_REL = 1e-4


def narrow_world_config():
    """narrow_config() plus a narrow LLM stack: 2 LLaMA layers (128 wide), 2
    tower layers (the last is not run) on 224x224 images of 256 patches, the
    product's cluster rates 64/32/16, 2 Q-Former layers, 64 prefix rows and
    77 queries."""
    import dataclasses
    from open_pandora_tpu_torch.core import config as c
    return dataclasses.replace(
        narrow_config(),
        llama=c.LLaMAConfig(hidden_size=128, intermediate_size=256,
                            num_layers=2, num_heads=4),
        clip_tower=c.CLIPTowerConfig(width=64, layers=3, heads=2),
        qformer=c.QFormerConfig(hidden_size=64, num_layers=2, num_heads=2,
                                intermediate_size=128),
        connector=c.ConnectorConfig(llm_hidden=128, qformer_proj_dim=64,
                                    proj_out_dim=64))


def check_world(device, seed: int, cfg=None, variant: str = "clip") -> None:
    """fp32: the narrow WorldModel's conditioning of a 2-round prompt (an
    image, then 16 frames as a video, bucketed texts) on the card against
    the same weights on the CPU; the cluster indices of the image cascade
    and the video's clustered tokens first, since one moved index would
    show as a large gap. `cfg` defaults to narrow_world_config();
    `variant` names it in the log."""
    from open_pandora_tpu_torch.models.cluster import (cluster_dpc_knn,
                                                       merge_tokens,
                                                       project_video_tokens)
    from open_pandora_tpu_torch.models.world_model import (next_round_prompt,
                                                           round1_prompt)
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model

    cfg = cfg or narrow_world_config()
    cpu = build_world_model(cfg, device="cpu",
                            generator=torch.Generator().manual_seed(seed + 6))
    card = copy.deepcopy(cpu).to(device)
    rng = np.random.default_rng(seed + 7)
    T, size = cfg.unet.temporal_length, cfg.clip_tower.image_size
    images = torch.from_numpy(rng.standard_normal(
        (1, 1 + T, size, size, 3), np.float32))
    texts, masks = [], []
    for n in (9, 5):                    # padded to the 16-token bucket
        ids = np.zeros((1, 16), np.int64)
        ids[0, :n] = rng.integers(3, 31000, n)
        texts.append(torch.from_numpy(ids))
        masks.append(torch.arange(16)[None] < n)
    prompt = next_round_prompt(
        round1_prompt(texts[0], images=images, text_mask=masks[0]),
        range(1, 1 + T), texts[1], text_mask=masks[1])

    got = {}
    for name, wm in (("card", card), ("cpu", cpu)):
        t0 = time.perf_counter()
        with torch.no_grad():
            feats = wm.encode_tower(images[0])
            idx, x = [], feats[:1]
            for r, k in zip(cfg.cluster.spatial_rates, (5, 3, 3)):
                i, c = cluster_dpc_knn(x, r, k)
                idx += [i.cpu(), c.cpu()]
                x = merge_tokens(x, i, r)
            video = project_video_tokens(feats[1:], cfg.cluster.spatial_rates,
                                         cfg.cluster.temporal_rate)
            cond = wm.get_diffusion_conditioning(prompt)
        got[name] = (idx, video.cpu(), cond.cpu())
        log("model", f"world fp32 {name}: {time.perf_counter() - t0:.1f} s")
    (ic, vc, cc), (ir, vr, cr) = got["card"], got["cpu"]
    same = all(torch.equal(a, b) for a, b in zip(ic, ir))
    v_err = (vc - vr).abs().max().item()
    c_err = (cc - cr).abs().max().item()
    v_scale, c_scale = vr.abs().max().item(), cr.abs().max().item()
    ok = (same and bool(torch.isfinite(cc).all())
          and v_err <= WORLD_BOUND_REL * v_scale
          and c_err <= WORLD_BOUND_REL * c_scale)
    log("model", json.dumps({
        "dtype": "float32", "world": True, "variant": variant,
        "conditioning": list(cc.shape),
        "cluster_indices_equal": same, "video_tokens_max_abs_err": v_err,
        "video_tokens_scale": v_scale, "conditioning_max_abs_err": c_err,
        "conditioning_scale": c_scale, "bound_rel": WORLD_BOUND_REL,
        "ok": ok}))
    if cc.shape != (1, 2, cfg.qformer.num_query_tokens,
                    cfg.connector.proj_out_dim) or not ok:
        raise AssertionError("card and CPU conditioning disagree")


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

def conv_sites(u, hz: int, wz: int) -> list:
    """(kind, h, w, c, co) of every stride-1 3x3 conv of the UNet that may
    take the opt-in conv routes, on a hz x wz latent: the input conv
    ("input"), both convs of each ResBlock ("res"), the Upsample convs
    ("up"). The output conv and the Downsample stay library convs."""
    mc = u.model_channels
    sites = [("input", hz, wz, u.in_channels, mc)]
    chans, ch, ds = [mc], mc, 1

    def res(c_in, c_out):
        sites.extend([("res", hz // ds, wz // ds, c_in, c_out),
                      ("res", hz // ds, wz // ds, c_out, c_out)])
    for level, mult in enumerate(u.channel_mult):
        for _ in range(u.num_res_blocks):
            res(ch, mult * mc)
            ch = mult * mc
            chans.append(ch)
        if level != len(u.channel_mult) - 1:
            chans.append(ch)
            ds *= 2
    res(ch, ch)                         # middle block
    res(ch, ch)
    for level, mult in reversed(list(enumerate(u.channel_mult))):
        for i in range(u.num_res_blocks + 1):
            res(ch + chans.pop(), mult * mc)
            ch = mult * mc
            if level and i == u.num_res_blocks:
                ds //= 2
                sites.append(("up", hz // ds, wz // ds, ch, ch))
    return sites


def predicted_launches(cfg, height: int, width: int, steps: int,
                       frame_chunk: int, fused: bool, batch: int = 2
                       ) -> dict:
    """Kernel launches of one synthesize() call, derived from the model's
    structure and the port's gates on the shapes each site sees: the
    dispatcher's routes (attention_route), on the fused route (bf16 eval on
    a CUDA device) the packed, fused temporal, GroupNorm and fused GEGLU
    gates, and in eval on a CUDA device, in any dtype, the conv gates under
    the flags in force (core/flags.py): a ResBlock conv the fused conv
    kernel takes folds its GroupNorm into the kernel.
    Batched CFG runs cond and uncond as batch 2 (`batch`). Returns the
    counts per UNet eval ("per_eval"), per VAE encode and decode chunk, and
    for the clip (one key per kernel)."""
    from open_pandora_tpu_torch.ops.attention import attention_route
    from open_pandora_tpu_torch.ops.conv2d import (conv3x3_eligible,
                                                   conv3x3_fused_eligible)
    from open_pandora_tpu_torch.ops.dual_cross_attention import (
        dual_cross_attention_eligible)
    from open_pandora_tpu_torch.ops.fused_geglu import geglu_ff_eligible
    from open_pandora_tpu_torch.ops.fused_temporal import (
        fused_temporal_eligible)
    from open_pandora_tpu_torch.ops.packed_attention import (
        packed_attention_eligible, packed_regime)

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

    def packed_key(n, ms, h):           # the JAX kernel the shape belongs to
        return ("packed_multi" if packed_regime(n, ms, h) == "multi"
                else "packed")

    def ff(c):                          # a block's LN3 -> GEGLU -> residual
        if fused and geglu_ff_eligible(c):
            per_eval.append("fused_geglu")

    def temporal(ds, ch, heads):        # attn1 and attn2 both self-attend
        inner = heads * d
        gn(ch)
        for _ in range(depth):
            if (fused and not u.use_causal_attention
                    and fused_temporal_eligible(t, inner, inner, heads)):
                per_eval.extend(["fused_temporal"] * 2)
            else:
                q = (b * (hz // ds) * (wz // ds), t, heads, d)
                per_eval.extend([route(q, q)] * 2)
            ff(inner)

    def spatial(ds, ch):
        n, h = (hz // ds) * (wz // ds), ch // d
        q = (b * t, n, h, d)
        ms = ((u.text_context_len, u.img_tokens_per_frame)
              if u.image_cross_attention else (u.text_context_len,))
        gn(ch)
        for _ in range(depth):
            if fused and packed_attention_eligible(n, (n,), h, h * d):
                per_eval.append(packed_key(n, (n,), h))
            else:
                per_eval.append(route(q, q))
            if fused and packed_attention_eligible(n, ms, h, h * d):
                per_eval.append(packed_key(n, ms, h))
            elif (fused and len(ms) == 2
                    and dual_cross_attention_eligible(n, *ms, d)):
                per_eval.append("dual_cross")
            else:
                per_eval.extend(route(q, (b * t, m, h, d)) for m in ms)
            ff(ch)

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

    for kind, h, w, c, co in conv_sites(u, hz, wz):
        if conv3x3_fused_eligible(h, w, c, co):
            per_eval.append("conv3x3_fused")
            if kind == "res" and fused and c % 32 == 0:
                per_eval.remove("group_norm")
        elif conv3x3_eligible(h, w, c, co):
            per_eval.append("conv3x3")

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
                             frames: int, bf16: bool,
                             fine_remat: bool = False) -> dict:
    """Kernel launches of one finetune step: the UNet in training takes the
    unfused route (flash and small attention), forward once, again in the
    backward where cfg.unet.use_checkpoint recomputes each block, once
    more under PANDORA_FINE_REMAT (`fine_remat`: each attention is
    recomputed on its own inside the block's recompute), and each
    attention's backward kernel once; the frozen VAE encodes `frames`
    frames one at a time (the video and the conditioning frames) in eval,
    on its GroupNorm kernel in bf16. The text and image encoders launch
    none of these kernels (their attention takes the plain route)."""
    unet = predicted_launches(cfg, height, width, 1, frame_chunk=1,
                              fused=False, batch=batch)["per_eval"]
    encode = predicted_launches(cfg, height, width, 1, frame_chunk=1,
                                fused=bf16)["encode"]
    fwd = 1 + bool(cfg.unet.use_checkpoint) + fine_remat
    counts = {k: frames * encode[k] for k in KERNEL_KEYS}
    for key, bwd in (("flash", "flash_bwd"), ("small", "small_bwd")):
        counts[key] += fwd * unet[key]
        counts[bwd] += unet[key]
    return counts


def run_slice(device, seed: int, steps: int) -> tuple:
    """The clip on the default route; returns its launches and the model,
    which phase 5c runs again under the conv flags."""
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
    # temporal, 1 out), 33 fused GEGLU (every transformer block's
    # feed-forward: 16 spatial, 17 temporal); per clip the VAE adds 1 flash
    # for the encode and 1 per decode chunk, and its GroupNorms (22 per
    # encode, 30 per chunk)
    if (want["per_eval"] != {"flash": 0, "flash_bwd": 0, "small": 12,
                             "small_bwd": 0, "packed": 20, "packed_multi": 0,
                             "dual_cross": 0, "fused_temporal": 22,
                             "group_norm": 166, "conv3x3": 0,
                             "conv3x3_fused": 0, "fused_geglu": 33}
            or want["encode"]["flash"] != 1
            or want["decode_chunk"]["flash"] != 1):
        raise AssertionError(f"the routing predicts {want}")
    if launches != {k: want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"launches {launches} != predicted {want}")
    if min(launches[k] for k in EVAL_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return launches, model


# -- phase 5c: the opt-in conv routes at full width ----------------------------

# (flag, the conv kernel it routes to)
CONV_ROUTES = (("PANDORA_ENABLE_PCONV2", "conv3x3_fused"),
               ("PANDORA_ENABLE_PCONV", "conv3x3"))
CONV_SYNTH_STEPS = 2


def run_conv_route(device, seed: int, model) -> dict:
    """PandoraConfig()'s UNet (the phase-5 model, bf16) under the JAX
    package's opt-in conv flags, set through flags.overridden: one CFG eval
    at 320x512 on the default route, under PANDORA_ENABLE_PCONV2 and under
    PANDORA_ENABLE_PCONV, each routed output held to the default route's by
    the bf16 rule against an fp32 copy of the UNet on the card; launches
    against the census. Then synthesize() DDIM-2 and one CFG eval at
    576x1024 (the whole-C (72, 128, 960 -> 320) site) under
    PANDORA_ENABLE_PCONV2. Returns the flagged runs' launches."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.eval.inference import synthesize

    cfg = PandoraConfig()
    u = cfg.unet
    unet = model.model.diffusion_model
    gen = torch.Generator(device=device).manual_seed(seed + 11)
    total = dict.fromkeys(KERNEL_KEYS, 0)

    def inputs(hz, wz):
        def rnd(*shape):
            return torch.randn(*shape, generator=gen, device=device
                               ).to(torch.bfloat16)
        return (rnd(2, u.temporal_length, hz, wz, u.in_channels),
                torch.tensor([600, 600], device=device),
                rnd(2, u.text_context_len
                    + u.temporal_length * u.img_tokens_per_frame,
                    u.context_dim),
                torch.tensor([3, 3], device=device))

    def evaluate(m, args, timed=True):
        x, steps, ctx, fs = args
        dt = next(m.parameters()).dtype
        if timed:
            evaluate(m, args, timed=False)          # cold
            reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = m(x.to(dt), steps, ctx.to(dt), fs=fs)
        torch.cuda.synchronize()
        return out.float(), time.perf_counter() - t0

    args = inputs(40, 64)
    ref = copy.deepcopy(unet).float()
    eps32, _ = evaluate(ref, args, timed=False)
    del ref
    torch.cuda.empty_cache()
    eps16, wall = evaluate(unet, args)
    base = predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                              fused=True)["per_eval"]
    got = read_launches()
    log("slice", json.dumps({"conv_route": "default", "flags":
                             flags.snapshot(), "eval_s": wall,
                             "launches": got}))
    if got != base:
        raise AssertionError(f"default eval launches {got} != {base}")
    base_err = (eps16 - eps32).abs().max().item()
    limit = 2 * base_err + 1e-2 * eps32.abs().mean().item()
    for flag, key in CONV_ROUTES:
        with flags.overridden(**{flag: True}):
            eps, wall = evaluate(unet, args)
            got = read_launches()
            want = predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                                      fused=True)["per_eval"]
            snap = flags.snapshot()
        err32 = (eps - eps32).abs().max().item()
        err16 = (eps - eps16).abs().max().item()
        gn_drop = base["group_norm"] - want["group_norm"]
        log("slice", json.dumps({
            "conv_route": key, "flags": snap, "eval_s": wall,
            "max_abs_err_vs_fp32": err32, "max_abs_err_vs_default": err16,
            "default_max_abs_err_vs_fp32": base_err, "limit": limit,
            "group_norm_drop": gn_drop, "launches": got,
            "predicted": want}))
        # PandoraConfig() at 320x512: 23 routed sites (the input conv, two
        # Upsample convs, the two convs of the ten 40x64 and 20x32
        # ResBlocks); under PCONV2 those 20 ResBlock convs take their
        # GroupNorm along
        if want[key] != 23 or gn_drop != (20 if key == "conv3x3_fused"
                                          else 0):
            raise AssertionError(f"the routing predicts {want}")
        if got != want:
            raise AssertionError(f"{flag}: launches {got} != {want}")
        if not (bool(torch.isfinite(eps).all()) and err32 <= limit
                and err16 <= limit):
            raise AssertionError(f"{flag}: routed eval beyond the bf16 rule")
        for k in KERNEL_KEYS:
            total[k] += got[k]

    image = np.random.default_rng(seed).integers(0, 256, (360, 640, 3),
                                                 dtype=np.uint8)
    timings = {}
    with flags.overridden(ENABLE_PCONV2=True):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        frames = synthesize(model, image, "a red car drives along a coastal "
                            "road at sunset", height=320, width=512,
                            ddim_steps=CONV_SYNTH_STEPS, guidance_scale=7.5,
                            guidance_rescale=0.7, eta=1.0, fs=3,
                            generator=torch.Generator(device=device)
                            .manual_seed(seed + 12), timings=timings)
        got = read_launches()
        want = predicted_launches(cfg, 320, 512, CONV_SYNTH_STEPS,
                                  frame_chunk=8, fused=True)
        snap = flags.snapshot()
    log("slice", json.dumps({
        "conv_route": "synthesize", "flags": snap,
        "frames": list(frames.shape), "ddim_steps": CONV_SYNTH_STEPS,
        **timings, "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": got}))
    if frames.shape != (1, 16, 320, 512, 3) or not np.isfinite(frames).all():
        raise AssertionError(f"bad clip: {frames.shape}")
    if got != {k: want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"conv synthesize: launches {got} != {want}")
    for k in KERNEL_KEYS:
        total[k] += got[k]

    args = inputs(72, 128)
    eps_default, wall_default = evaluate(unet, args, timed=False)
    with flags.overridden(ENABLE_PCONV2=True):
        eps, wall = evaluate(unet, args)
        got = read_launches()
        want = predicted_launches(cfg, 576, 1024, 1, frame_chunk=2,
                                  fused=True)["per_eval"]
        snap = flags.snapshot()
    log("slice", json.dumps({
        "conv_route": "conv3x3_fused", "hw": [576, 1024], "flags": snap,
        "eval_s": wall, "default_eval_s_first_call": wall_default,
        "max_abs_diff_vs_default": (eps - eps_default).abs().max().item(),
        "mean_abs_default": eps_default.abs().mean().item(),
        "launches": got, "predicted": want}))
    # 34 routed sites at 576x1024: the input conv, three Upsample convs and
    # the two convs of fifteen ResBlocks, (72, 128, 960 -> 320) whole
    if want["conv3x3_fused"] != 34:
        raise AssertionError(f"the routing predicts {want}")
    if got != want or not bool(torch.isfinite(eps).all()):
        raise AssertionError(f"576x1024: launches {got} != {want}, or "
                             "non-finite")
    for k in KERNEL_KEYS:
        total[k] += got[k]
    if min(total[k] for k in ("conv3x3", "conv3x3_fused")) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


# -- phase 5d: the conv routes in an fp32 UNet eval ---------------------------

CONV_FP32_REL = 1e-3    # a routed fp32 eval against the default route's,
                        # relative to max|eps|: wiring only (phase 3 holds
                        # the kernels' precision)


def run_conv_fp32(device, seed: int) -> dict:
    """PandoraConfig()'s UNet in fp32 (random weights from the seed), one
    CFG eval at 320x512 on the default route (cuDNN's fp32 convs, TF32
    off), then under PANDORA_ENABLE_PCONV2 and under PANDORA_ENABLE_PCONV:
    the 23 routed conv sites on the fp32 conv kernel, rows 3-5 not at all
    (the fused route is bf16's); each eval's launches against the
    routing, its eps within CONV_FP32_REL max|eps| of the default route's,
    its distance from the default route with TF32 allowed beside it (the
    library's own fp32 shortcut, context only), and seconds per eval (a
    cold call, then two timed). Returns the evals' launches."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.unet3d import UNetModel

    cfg = PandoraConfig()
    u = cfg.unet
    gen = torch.Generator(device=device).manual_seed(seed + 13)
    with torch.device("meta"):
        unet = UNetModel(u)
    unet = unet.to_empty(device=device).eval()
    init_random_(unet, gen)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device)
    x = rnd(2, u.temporal_length, 40, 64, u.in_channels)
    ctx = rnd(2, u.text_context_len
              + u.temporal_length * u.img_tokens_per_frame, u.context_dim)
    steps = torch.tensor([600, 600], device=device)
    fs = torch.tensor([3, 3], device=device)

    def evaluate():
        with torch.no_grad():
            out = unet(x, steps, ctx, fs=fs)
        torch.cuda.synchronize()
        return out

    def timed():
        evaluate()                                  # cold
        reset_launches()
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = evaluate()
            walls.append(time.perf_counter() - t0)
        return out, walls, {k: n // 2 for k, n in read_launches().items()}

    total = dict.fromkeys(KERNEL_KEYS, 0)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        eps_tf32 = evaluate()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    eps0, walls, got = timed()
    scale = eps0.abs().max().item()
    log("conv_fp32", json.dumps({
        "conv_route": "default", "dtype": "float32", "eval_s": walls,
        "max_abs_eps": scale,
        "max_abs_diff_vs_default_tf32": (eps0 - eps_tf32).abs().max().item(),
        "launches": got}))
    want = predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                              fused=False)["per_eval"]
    if got != want or not bool(torch.isfinite(eps0).all()):
        raise AssertionError(f"fp32 default eval: launches {got} != {want}, "
                             "or non-finite")
    for k in KERNEL_KEYS:
        total[k] += 2 * got[k]
    for flag, key in CONV_ROUTES:
        with flags.overridden(**{flag: True}):
            eps, walls, got = timed()
            want = predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                                      fused=False)["per_eval"]
            snap = flags.snapshot()
        diff = (eps - eps0).abs().max().item()
        log("conv_fp32", json.dumps({
            "conv_route": key, "dtype": "float32", "flags": snap,
            "eval_s": walls, "max_abs_diff_vs_default": diff,
            "limit": CONV_FP32_REL * scale,
            "max_abs_diff_vs_default_tf32": (eps - eps_tf32).abs().max()
            .item(), "launches": got, "predicted": want}))
        # 23 routed sites at 320x512, as in bf16 (phase 5c); the fp32 eval
        # takes no packed, fused temporal or GroupNorm kernel (rows 3-5)
        if want[key] != 23 or any(want[k] for k in ("packed", "group_norm",
                                                      "fused_temporal")):
            raise AssertionError(f"the routing predicts {want}")
        if got != want:
            raise AssertionError(f"fp32 {flag}: launches {got} != {want}")
        if not (bool(torch.isfinite(eps).all())
                and diff <= CONV_FP32_REL * scale):
            raise AssertionError(f"fp32 {flag}: eps {diff} from the default "
                                 "route's")
        for k in KERNEL_KEYS:
            total[k] += 2 * got[k]
    del unet
    torch.cuda.empty_cache()
    if min(total[k] for k in ("conv3x3", "conv3x3_fused")) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


# -- phase 6: the trainer at full width ---------------------------------------

TRAIN_STEPS = 3


def run_train(device, seed: int, fp32: bool = False) -> dict:
    """The port's trainer on the full-width PandoraConfig() in bf16
    (stage dynamicrafter, synthetic data, batch 1 at 320x512x16f), a few
    steps into a temporary logdir removed afterwards; with `fp32` (phase
    6b) under dtype_policy=fp32, the JAX trainer's precision, where rows 1
    and 9 run their fp32 kernels."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.train import trainer

    cfg = PandoraConfig()
    name = "phase6b" if fp32 else "phase6"
    policy = ["--set", "dtype_policy=fp32"] if fp32 else []
    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.run([
            "--synthetic-data", "--max-steps", str(TRAIN_STEPS),
            "--logdir", logdir, "--name", name, "--device", "cuda",
            "--set", "train.stage=dynamicrafter",
            "--set", "train.log_every=1", "--set", f"train.seed={seed}",
            *policy])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(logdir, name, "loginfo",
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
                                    bf16=not fp32)
    report = {
        "config": f"PandoraConfig() {'fp32' if fp32 else 'bf16'}",
        "steps": TRAIN_STEPS,
        "trainable_parameters": n_params, "wall_s": wall,
        "sec_per_step": [r["sec_per_step"] for r in recs],
        "loss": [r["loss"] for r in recs],
        "loss_simple": [r["loss_simple"] for r in recs],
        "grad_norm": [r["grad_norm"] for r in recs],
        "attention_grad_norms": grad_norms, "max_memory_allocated": peak,
        "launches": launches, "predicted_per_step": want}
    log("train_fp32" if fp32 else "train", json.dumps(report))
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
    # with one flash and, in bf16, 22 GroupNorm launches (fp32 takes the
    # unfused GroupNorm)
    if (want["flash_bwd"], want["small_bwd"], want["small"], want["flash"],
            want["group_norm"]) != (10, 34, 68, 37, 0 if fp32 else 374):
        raise AssertionError(f"the routing predicts {want}")
    if launches != {k: TRAIN_STEPS * want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"launches {launches} != {TRAIN_STEPS} x "
                             f"{want}")
    keys = TRAIN_FP32_KEYS if fp32 else TRAIN_KEYS
    if min(launches[k] for k in keys) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return launches


# -- phase 5b: head width 80, the dual cross-attention route -------------------

def run_wide_heads(device, seed: int) -> dict:
    """One CFG UNet eval of PandoraConfig()'s UNet at 320x512 with
    num_head_channels=80 (4, 8 and 16 heads), random weights, bf16: another
    configuration than the product's (whose heads are 64 wide), the one
    whose attn2 the dual cross-attention kernel serves."""
    import dataclasses
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.unet3d import UNetModel

    cfg = PandoraConfig()
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, num_head_channels=80))
    u = cfg.unet
    with torch.device("meta"):
        unet = UNetModel(u)
    unet = unet.to(torch.bfloat16).to_empty(device=device).eval()
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    init_random_(unet, gen)
    T, hz, wz = u.temporal_length, 40, 64

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device
                           ).to(torch.bfloat16)
    x = rnd(2, T, hz, wz, u.in_channels)
    ctx = rnd(2, u.text_context_len + T * u.img_tokens_per_frame,
              u.context_dim)
    steps = torch.tensor([600, 600], device=device)
    fs = torch.tensor([3, 3], device=device)

    def run():
        with torch.no_grad():
            return unet(x, steps, ctx, fs=fs)
    run()                                   # cold
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    eps = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = predicted_launches(cfg, 320, 512, 1, frame_chunk=8,
                              fused=True)["per_eval"]
    finite = bool(torch.isfinite(eps).all())
    log("slice", json.dumps({
        "wide_heads": True, "num_head_channels": 80,
        "eps": list(eps.shape), "finite": finite,
        "std": float(eps.float().std()), "eval_s": wall,
        "launches": launches, "predicted": want}))
    if eps.shape != (2, T, hz, wz, u.out_channels) or not finite:
        raise AssertionError(f"bad eval: {eps.shape}")
    # attn2 of the ten spatial transformers at 2560 and 640 tokens: dual
    # cross-attention; their attn1: flash; all 34 temporal attentions: small
    if (want["dual_cross"], want["flash"], want["small"], want["packed"],
            want["fused_temporal"]) != (10, 10, 34, 0, 0):
        raise AssertionError(f"the routing predicts {want}")
    if launches != want:
        raise AssertionError(f"launches {launches} != predicted {want}")
    if min(launches[k] for k in WIDE_HEAD_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return launches


# one bf16 CFG eval of svd_xt's VideoUNet at 576x1024x25 (2 videos of 25
# frames): row 13 at the 16 transformers' spatial ff, ff_in and ff; row 2
# at their self-attention over t = 25; rows 3 and 7 at the spatial
# self-attention of levels 0-2 (the middle's 144 tokens take the plain
# route); GroupNorm+SiLU at every ResBlock, time stack and transformer
SVD_EVAL_LAUNCHES = {"small": 16, "packed": 10, "packed_multi": 5,
                     "group_norm": 105, "fused_geglu": 48}


def run_svd(device, seed: int) -> dict:
    """Phase 5e: one CFG eval of svd_xt's VideoUNet at 576x1024x25, random
    weights, bf16 (the eval route of the svdxt.i2v cell): launches against
    SVD_EVAL_LAUNCHES (every other kernel none), seconds an eval."""
    from open_pandora_tpu_torch.core.config import SVDConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.svd import VideoUNet

    u = SVDConfig().video_unet
    with torch.device("meta"):
        unet = VideoUNet(u)
    unet = unet.to(torch.bfloat16).to_empty(device=device).eval()
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    init_random_(unet, gen)
    T, hz, wz = u.num_frames, 72, 128

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=device
                           ).to(torch.bfloat16)
    x = rnd(2, T, hz, wz, u.in_channels)
    ctx = rnd(2, 1, u.context_dim)
    y = rnd(2, u.adm_in_channels)
    c_noise = torch.full((2,), 0.25 * float(np.log(10.0)), device=device)

    def run():
        with torch.no_grad():
            return unet(x, c_noise, ctx, y)
    run()                                   # cold
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = {k: SVD_EVAL_LAUNCHES.get(k, 0) for k in KERNEL_KEYS}
    finite = bool(torch.isfinite(out).all())
    log("svd", json.dumps({
        "out": list(out.shape), "finite": finite,
        "std": float(out.float().std()), "eval_s": wall,
        "launches": launches, "predicted": want}))
    if out.shape != (2, T, hz, wz, u.out_channels) or not finite:
        raise AssertionError(f"bad eval: {out.shape}")
    if launches != want:
        raise AssertionError(f"launches {launches} != predicted {want}")
    return launches


# -- phase 7: a ChatWM session at 576x1024, full width ----------------------------

WORLD_HW = (576, 1024)
WORLD_STEPS = 4
WORLD_TEXTS = ("the car drives forward along the coastal road",
               "the car turns left towards the sea")


def predicted_round(cfg, height: int, width: int, steps: int,
                    cond_frames: int) -> dict:
    """Kernel launches of one ChatWM round: `steps` UNet evals, one VAE
    encode per conditioning frame, the decode in chunks of 2 (8 at 320x512).
    The LLM conditioning launches none of these kernels: the tower (257
    rows), the bucketed and so masked prefill and the Q-Former (77 rows)
    all take the plain attention route, as in the JAX package."""
    chunk = 8 if height * width <= 320 * 512 else 2
    p = predicted_launches(cfg, height, width, steps, frame_chunk=chunk,
                           fused=True)
    return {k: p[k] + (cond_frames - 1) * p["encode"][k]
            for k in KERNEL_KEYS}


def run_world(device, seed: int, prompts: list = None) -> dict:
    """Phase 7; with a `prompts` list, the round-2 prompt's LLaMA input
    embeddings (1, 384, 4096) are appended to it (on the CPU)."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.pipeline.chat_wm import (ChatWM,
                                                         build_world_model)

    cfg = PandoraConfig()
    h, w = WORLD_HW
    t0 = time.perf_counter()
    wm = build_world_model(cfg, device=device, dtype=torch.bfloat16,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed + 9))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in wm.parameters())
    n_llama = sum(p.numel() for n, p in wm.llama.named_parameters()
                  if not n.startswith(("model.vision_tower",
                                       "model.mm_projector")))
    log("world", f"PandoraConfig() WorldModel bf16, {n_params} parameters "
        f"({n_llama} LLaMA, {len(wm.llama.model.layers)} layers; tower "
        f"{len(wm.clip_tower.encoder.layers)} layers run; Q-Former "
        f"{len(wm.connector.diffusion_qformer.encoder.layer)} layers), "
        f"built in {time.perf_counter() - t0:.1f} s")
    image = np.random.default_rng(seed + 10).integers(
        0, 256, (720, 1280, 3), dtype=np.uint8)
    chat = ChatWM(wm, height=h, width=w)
    # record what each round hands the encoders
    seen, real_streams = [], wm.diffusion.synthesis_streams

    def streams_spy(**kw):
        seen.append(kw["cond_frames"])
        return real_streams(**kw)
    wm.diffusion.synthesis_streams = streams_spy
    real_trunk = wm.llama.trunk

    def trunk_spy(embeds, *a, **kw):
        if prompts is not None and embeds.shape[1] == 384:
            prompts.append(embeds.detach().cpu())
        return real_trunk(embeds, *a, **kw)
    wm.llama.trunk = trunk_spy
    torch.cuda.reset_peak_memory_stats()
    frames, launches, total = [], [], dict.fromkeys(KERNEL_KEYS, 0)
    for r, text in enumerate(WORLD_TEXTS):
        reset_launches()
        kw = dict(ddim_steps=WORLD_STEPS, seed=seed, guidance_scale=7.5,
                  guidance_rescale=0.7, fs=3)
        out = (chat.generate_video(image, text, **kw) if r == 0
               else chat.generate_video_next_round(text, **kw))
        got = read_launches()
        want = predicted_round(cfg, h, w, WORLD_STEPS, 1 if r == 0 else 4)
        log("world", json.dumps({
            "round": r, **chat.round_times[r], "frames": list(out.shape),
            "dtype": str(out.dtype), "min": int(out.min()),
            "max": int(out.max()), "std": float(out.std()),
            "launches": got, "predicted": want}))
        if out.shape != (16, h, w, 3) or out.dtype != np.uint8:
            raise AssertionError(f"bad frames: {out.shape} {out.dtype}")
        if float(out.std()) == 0.0:
            raise AssertionError("constant clip")
        if got != want:
            raise AssertionError(f"round {r}: launches {got} != {want}")
        frames.append(out)
        launches.append(got)
        for k in KERNEL_KEYS:
            total[k] += got[k]
    peak = torch.cuda.max_memory_allocated()
    # round 2's conditioning frames are round 1's last four, through uint8
    chained = (seen[1].shape == (1, 4, h, w, 3) and torch.equal(
        seen[1][0].cpu(),
        torch.from_numpy(frames[0][-4:].astype(np.float32) / 127.5 - 1.0)))
    spliced = [chat.round_times[r]["prompt_len"] for r in range(2)]
    log("world", json.dumps({
        "rounds": 2, "ddim_steps": WORLD_STEPS, "prompt_len": spliced,
        "round2_conditions_on_round1_last4": chained,
        "max_memory_allocated": peak, "launches": total,
        "video": list(np.concatenate(
            [frames[0][:12], frames[1]]).shape)}))
    # 112 image tokens, a 16-token text bucket (bos included), 64 prefix
    # rows; round 2 adds 112 video tokens (one event), 16 and 64
    if spliced != [192, 384]:
        raise AssertionError(f"spliced prompt lengths {spliced}")
    if not chained or chat.prompt.segments[4].indices != tuple(range(1, 17)):
        raise AssertionError("round 2 did not take round 1's frames")
    if min(total[k] for k in WORLD_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


# -- phase 8: the LLM training stages at full width ----------------------------

LLM_STAGE_STEPS = 2
LLM_TEXT_LEN = 16       # data.webvid.PrefetchLoader's llm_text_len
LORA_RANK, LORA_ALPHA = 64, 16.0     # ChatUniVi's r and alpha


def llm_prompt_len(cfg) -> int:
    """The round-1 training prompt of alignment and finetune: bos, the
    image's clustered tokens, the caption bucket's rest, the prefix."""
    return (LLM_TEXT_LEN + sum(cfg.cluster.spatial_rates)
            + cfg.connector.image_prefix_length)


def llm_attention_sites(cfg, stage: str, batch: int, prompt_len: int
                        ) -> list:
    """(q shape, k shape, causal, masked, calls, backward) of each attention
    call one step of an LLM stage makes outside the UNet and the VAE; the
    calls whose inputs carry a gradient (`backward`) would launch a
    backward kernel on the flash or small route. The CLIP tower (1 + 256
    rows at 224) and the LLaMA prefill (causal; masked in llm_sft, whose
    pads are masked) in every stage; the Q-Former (77 queries, their
    cross-attention to the 64 prefix rows) and the OpenCLIP text encoder
    (77 rows, causal: the caption in alignment, the empty prompt of the CFG
    dropout in finetune) with the connector; the OpenCLIP ViT-H and the
    Resampler in finetune."""
    def shape(n, heads, width):
        return (batch, n, heads, width // heads)
    t = cfg.clip_tower
    tower = shape((t.image_size // t.patch_size) ** 2 + 1, t.heads, t.width)
    lm = cfg.llama
    prefill = shape(prompt_len, lm.num_heads, lm.hidden_size)
    sites = [(tower, tower, False, False, t.layers + 1 + t.select_layer,
              False),
             (prefill, prefill, True, stage == "llm_sft", lm.num_layers,
              True)]
    if stage in ("alignment", "finetune"):
        q = cfg.qformer
        qs = shape(q.num_query_tokens, q.num_heads, q.hidden_size)
        ks = shape(cfg.connector.image_prefix_length, q.num_heads,
                   q.hidden_size)
        c = cfg.clip_text
        text = shape(c.context_length, c.heads, c.width)
        sites += [(qs, qs, False, False, q.num_layers, True),
                  (qs, ks, False, False,
                   len(range(0, q.num_layers, q.cross_attention_frequency)),
                   True),
                  (text, text, True, False, c.layers - c.penultimate,
                   False)]
    if stage == "finetune":
        v, r = cfg.clip_vision, cfg.resampler
        vit = shape((v.image_size // v.patch_size) ** 2 + 1, v.heads,
                    v.width)
        lat = (batch, r.num_queries * r.video_length, r.heads, r.dim_head)
        kv = (batch, vit[1] + lat[1], r.heads, r.dim_head)
        sites += [(vit, vit, False, False, v.layers, False),
                  (lat, kv, False, False, r.depth, False)]
    return sites


def predicted_llm_stage_launches(cfg, stage: str, height: int, width: int,
                                 batch: int, prompt_len: int,
                                 fine_remat: bool = False) -> dict:
    """Kernel launches of one step of an LLM stage, from the routing
    functions: finetune's UNet and VAE launch as the dynamicrafter step
    does (predicted_train_launches); every attention site of the LLM side
    goes through ops.attention.attention_route as on a CUDA device."""
    from open_pandora_tpu_torch.ops.attention import attention_route

    counts = dict.fromkeys(KERNEL_KEYS, 0)
    if stage == "finetune":
        counts = predicted_train_launches(
            cfg, height, width, batch=batch,
            frames=cfg.train.video_length + 1, bf16=True,
            fine_remat=fine_remat)
    for q, k, causal, masked, calls, backward in llm_attention_sites(
            cfg, stage, batch, prompt_len):
        route = attention_route(q, k, causal=causal, masked=masked,
                                on_device=True)
        if route != "plain":
            counts[route] += calls
            if backward:
                counts[f"{route}_bwd"] += calls
    return counts


def _llm_stage(name: str, state, step_fn, batches, watch=None) -> dict:
    """Steps one stage on `batches`; its metrics, seconds per step, peak
    memory and launches, and the gradient norm of `watch` after each
    step."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    recs, watched = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in step_fn(state, batch).items()}
        torch.cuda.synchronize()
        recs.append({**m, "sec_per_step": time.perf_counter() - t0})
        if watch is not None:
            watched.append(watch.grad.float().norm().item())
    return {"stage": name, "steps": len(recs),
            "trainable_parameters": sum(p.numel() for p in
                                        state.trainable.values()),
            "loss": [r["loss"] for r in recs],
            "grad_norm": [r["grad_norm"] for r in recs],
            "sec_per_step": [r["sec_per_step"] for r in recs],
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "launches": read_launches(),
            **({"image_prefix_grad_norm": watched} if watch is not None
               else {})}


def _check_llm_stage(rep: dict, want: dict) -> None:
    name = rep["stage"]
    finite = all(np.isfinite(x) for k in ("loss", "grad_norm")
                 for x in rep[k])
    if rep["steps"] != LLM_STAGE_STEPS or not finite:
        raise AssertionError(f"{name}: bad metrics {rep}")
    if min(rep["grad_norm"]) <= 0:
        raise AssertionError(f"{name}: zero gradients {rep['grad_norm']}")
    # the gradient crossed the frozen LLaMA into the learned prefix rows
    if "image_prefix_grad_norm" in rep and not max(
            rep["image_prefix_grad_norm"]) > 0:
        raise AssertionError(f"{name}: no image_prefix gradient")
    per_step = {k: LLM_STAGE_STEPS * want[k] for k in KERNEL_KEYS}
    if rep["launches"] != per_step:
        raise AssertionError(f"{name}: launches {rep['launches']} != "
                             f"{per_step}")


def run_train_llm(device, seed: int) -> dict:
    """The LLM training stages on the full-width PandoraConfig()
    WorldModel in bf16, batch 1, synthetic data: finetune through the
    trainer (train.trainer.run, 320x512x16f); then one WorldModel, built
    once, through the stages' step functions: alignment, llm_sft in full
    and llm_sft with LoRA adapters (grafted onto the same LLaMA)."""
    import itertools
    from open_pandora_tpu_torch.core.config import PandoraConfig, TrainConfig
    from open_pandora_tpu_torch.data.sft import (ConversationDataset,
                                                 synthetic_conversations)
    from open_pandora_tpu_torch.data.webvid import (PrefetchLoader,
                                                    SyntheticVideoDataset)
    from open_pandora_tpu_torch.models.lora import add_lora_
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model
    from open_pandora_tpu_torch.pipeline.tokenizers import load_tokenizer
    from open_pandora_tpu_torch.train import trainer
    from open_pandora_tpu_torch.train.llm_step import make_llm_sft_step
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_alignment_step)

    cfg = PandoraConfig()
    h, w = cfg.train.height, cfg.train.width
    plen = llm_prompt_len(cfg)
    want = {stage: predicted_llm_stage_launches(cfg, stage, h, w, 1, plen)
            for stage in ("alignment", "finetune", "llm_sft")}
    log("train_llm", f"predicted launches per step: {json.dumps(want)}")
    # per step at 320x512, batch 1: finetune's UNet and VAE as phase 6's
    # step (10 flash-bwd, 34 small-bwd, 68 small, 37 flash, 374 GroupNorm);
    # the LLM side launches nothing: the 192-row prefill is under the
    # flash gate (512 rows) and masked in llm_sft, the tower's 257 rows
    # are under it too, the Q-Former and text encoder are short
    if ({k: want["finetune"][k] for k in TRAIN_KEYS} != {
            "flash": 37, "flash_bwd": 10, "small": 68, "small_bwd": 34,
            "group_norm": 374}
            or any(want["alignment"].values())
            or any(want["llm_sft"].values())):
        raise AssertionError(f"the routing predicts {want}")
    reports, total = [], dict.fromkeys(KERNEL_KEYS, 0)

    # finetune through the trainer; the hook reads the prefix rows'
    # gradient at each step
    prefix_norms, real_stage_step = [], trainer._stage_step

    def stage_step_spy(model, *args):
        model.connector.image_prefix.weight.register_post_accumulate_grad_hook(
            lambda p: prefix_norms.append(p.grad.float().norm().item()))
        return real_stage_step(model, *args)
    logdir = tempfile.mkdtemp(prefix="chip_smoke_train_llm_")
    trainer._stage_step = stage_step_spy
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        state = trainer.run([
            "--synthetic-data", "--max-steps", str(LLM_STAGE_STEPS),
            "--logdir", logdir, "--name", "phase8", "--device", "cuda",
            "--set", "train.stage=finetune", "--set", "train.log_every=1",
            "--set", f"train.seed={seed}"])
        torch.cuda.synchronize()
        with open(os.path.join(logdir, "phase8", "loginfo",
                               "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
    finally:
        trainer._stage_step = real_stage_step
        shutil.rmtree(logdir, ignore_errors=True)
    reports.append({
        "stage": "finetune", "steps": len(recs),
        "trainable_parameters": sum(p.numel() for p in
                                    state.trainable.values()),
        "loss": [r["loss"] for r in recs],
        "grad_norm": [r["grad_norm"] for r in recs],
        "sec_per_step": [r["sec_per_step"] for r in recs],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": read_launches(), "image_prefix_grad_norm": prefix_norms})
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    wm = build_world_model(cfg, device=device, dtype=torch.bfloat16,
                           generator=torch.Generator(device=device)
                           .manual_seed(seed + 11))
    torch.cuda.synchronize()
    log("train_llm", f"PandoraConfig() WorldModel bf16 built in "
        f"{time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(seed=seed)
    clips = PrefetchLoader(
        SyntheticVideoDataset(video_length=cfg.train.video_length,
                              resolution=(h, w),
                              clip_size=cfg.clip_tower.image_size),
        1, text_len=cfg.clip_text.context_length,
        llm_tokenizer=load_tokenizer(), llm_text_len=LLM_TEXT_LEN)
    chats = ConversationDataset(
        [], load_tokenizer(), clip_size=cfg.clip_tower.image_size,
        seed=seed, records=synthetic_conversations(8, seed))

    def first(batches):
        return list(itertools.islice(batches, LLM_STAGE_STEPS))

    def run_stage(name, stage_key, step_fn, batches, watch=None):
        state = TrainState.create(wm, stage_key, tcfg)
        rep = _llm_stage(name, state, step_fn, batches, watch)
        del state
        for p in wm.parameters():
            p.grad = None
        torch.cuda.empty_cache()
        return rep

    reports.append(run_stage(
        "alignment", "alignment", make_alignment_step(wm, tcfg),
        first(clips.epoch(0)), watch=wm.connector.image_prefix.weight))
    sft_batches = first(chats.batches(1, cfg, bucket=32))
    reports.append(run_stage("llm_sft", "llm_sft",
                             make_llm_sft_step(wm, tcfg), sft_batches))
    # LoRA: adapters on the same LLaMA's projections
    add_lora_(wm.llama, LORA_RANK, LORA_ALPHA,
              torch.Generator(device=device).manual_seed(seed + 12))
    layer = wm.llama.model.layers[0].self_attn.q_proj
    before = {"frozen": layer.weight.detach().clone(),
              "adapter": layer.lora_b.detach().clone()}
    rep = run_stage("llm_sft_lora", "llm_sft_lora",
                    make_llm_sft_step(wm, tcfg), sft_batches)
    rep["changed"] = {"frozen q_proj.weight": not torch.equal(
        layer.weight, before["frozen"]), "adapter q_proj.lora_b":
        not torch.equal(layer.lora_b, before["adapter"])}
    reports.append(rep)
    del wm, layer, before
    torch.cuda.empty_cache()

    for rep in reports:
        log("train_llm", json.dumps(rep))
        _check_llm_stage(rep, want[rep["stage"].replace("_lora", "")])
        for k in KERNEL_KEYS:
            total[k] += rep["launches"][k]
    lora = reports[-1]["changed"]
    if lora["frozen q_proj.weight"] or not lora["adapter q_proj.lora_b"]:
        raise AssertionError(f"LoRA SFT changed the wrong tensors: {lora}")
    if min(total[k] for k in TRAIN_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


# -- phase 9: the CLI and the HTTP server at full width -------------------------

ENTRY_STEPS = 4
ENTRY_ACTIONS = ("the car drives forward along the coastal road",
                 "the car turns left towards the sea")
ENTRY_KEYS = EVAL_KEYS


def _post_generate(base: str, image: np.ndarray, actions, **fields) -> bytes:
    """POST /generate with the image as np.save bytes (the card's machine
    decodes neither PNG nor mp4) and the form's fields."""
    import io
    import urllib.request

    buf = io.BytesIO()
    np.save(buf, image)
    boundary = "chipsmokeboundary"
    parts = [("image", buf.getvalue()),
             ("actions", "\n".join(actions).encode()),
             *((k, str(v).encode()) for k, v in fields.items())]
    body = b"".join(
        f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"'
        f'\r\n\r\n'.encode() + v + b"\r\n" for k, v in parts)
    body += f"--{boundary}--\r\n".encode()
    req = urllib.request.Request(base + "/generate", data=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.read()


def run_entry(device, seed: int) -> dict:
    """The user's entry points on the full-width PandoraConfig()
    WorldModel (bf16, 320x512, random weights, as the CLI without --ckpt):
    cli.build_chat from parsed defaults, cli.run with two actions at
    DDIM-4; then server.make_server on 127.0.0.1 (port 0) in a thread
    around the same session: /health, the page, and two POST /generate
    requests answered by an injected generate_fn (np.load of the upload,
    cli.run, np.save of the frames). The first request's frames must equal
    cli.run's on the same seed, the second's (the next seed) differ."""
    import io
    import threading
    import urllib.request

    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.pipeline import cli, server

    args = cli.build_parser().parse_args(
        ["--image", "unused.png", "--action", ENTRY_ACTIONS[0],
         "--action", ENTRY_ACTIONS[1], "--ddim-steps", str(ENTRY_STEPS),
         "--seed", str(seed)])
    cfg = PandoraConfig()
    h, w = args.height, args.width
    t0 = time.perf_counter()
    chat = cli.build_chat(args)
    torch.cuda.synchronize()
    log("entry", f"cli.build_chat: {args.height}x{args.width} bf16={args.bf16}"
        f" device={args.device}, built in {time.perf_counter() - t0:.1f} s")
    image = np.random.default_rng(seed + 20).integers(
        0, 256, (360, 640, 3), dtype=np.uint8)
    # two rounds: round 1 encodes one conditioning frame, round 2 four
    want = {k: sum(predicted_round(cfg, h, w, ENTRY_STEPS, c)[k]
                   for c in (1, 4)) for k in KERNEL_KEYS}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    total = dict.fromkeys(KERNEL_KEYS, 0)

    def counted(tag):
        got = read_launches()
        if got != want:
            raise AssertionError(f"{tag}: launches {got} != {want}")
        for k in KERNEL_KEYS:
            total[k] += got[k]
        reset_launches()

    frames = cli.run(chat, image, args)
    counted("cli.run")
    times = [dict(r) for r in chat.round_times]
    log("entry", json.dumps({
        "call": "cli.run", "rounds": times, "frames": list(frames.shape),
        "std": float(frames.std()), "launches": want}))
    t = cfg.unet.temporal_length    # round 1 gives all but its last 4
    if frames.shape != (2 * t - 4, h, w, 3) or frames.dtype != np.uint8:
        raise AssertionError(f"bad frames {frames.shape} {frames.dtype}")
    if float(frames.std()) == 0.0:
        raise AssertionError("constant clip")

    lock = threading.Lock()

    def generate_fn(image_bytes, actions, **kw):
        with lock:
            run_args = copy.copy(args)
            run_args.action = list(actions)
            run_args.ddim_steps = kw.get("ddim_steps", args.ddim_steps)
            run_args.seed = kw.get("seed", args.seed)
            out = cli.run(chat, np.load(io.BytesIO(image_bytes)), run_args)
            buf = io.BytesIO()
            np.save(buf, out)
            return buf.getvalue()

    srv = server.make_server(generate_fn, port=0, host="127.0.0.1")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/health", timeout=60) as r:
            health = json.load(r)
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
        served = []
        for i, s in enumerate((seed, seed + 1)):
            t0 = time.perf_counter()
            got = np.load(io.BytesIO(_post_generate(
                base, image, ENTRY_ACTIONS, ddim_steps=ENTRY_STEPS,
                seed=s)))
            wall = time.perf_counter() - t0
            counted(f"request {i}")
            served.append(got)
            log("entry", json.dumps({
                "call": f"POST /generate {i}", "seed": s, "wall_s": wall,
                "rounds": [dict(r) for r in chat.round_times],
                "frames": list(got.shape)}))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    diff = int(np.abs(served[0].astype(int) - frames.astype(int)).max())
    report = {"health": health, "page_is_servers": page == server.PAGE,
              "request0_max_diff_from_cli": diff,
              "request0_equal": bool(np.array_equal(served[0], frames)),
              "request1_differs": not np.array_equal(served[1], frames),
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "launches": total, "predicted_per_call": want}
    log("entry", json.dumps(report))
    if health != {"status": "ok"} or not report["page_is_servers"]:
        raise AssertionError(f"bad GET answers: {health}")
    if any(f.shape != frames.shape for f in served):
        raise AssertionError(f"bad served frames {[f.shape for f in served]}")
    # the kernels have no atomics: the same seed gives the same frames
    if not report["request0_equal"] or not report["request1_differs"]:
        raise AssertionError(f"served frames {report}")
    if min(total[k] for k in ENTRY_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    del chat
    torch.cuda.empty_cache()
    return total


# -- phase 10: the 576x1024 finetune through the trainer -------------------------

HIRES_CONFIG = "configs/finetune_1024.yaml"
HIRES_STEPS = 2
HIRES_KEYS = TRAIN_KEYS + ("packed", "fused_temporal", "packed_multi")


def tfevents_first_record_ok(path: str) -> bool:
    """The file's first TFRecord: its length and data each followed by
    their masked CRC-32C (utils/loggers), recomputed here."""
    import struct

    from open_pandora_tpu_torch.utils.loggers import masked_crc
    with open(path, "rb") as f:
        head = f.read(8)
        (n,) = struct.unpack("<Q", head)
        (crc_head,) = struct.unpack("<I", f.read(4))
        data = f.read(n)
        (crc_data,) = struct.unpack("<I", f.read(4))
    return crc_head == masked_crc(head) and crc_data == masked_crc(data)


def png_size(path: str) -> tuple:
    """(height, width) from a PNG's IHDR."""
    import struct
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def run_train_hires(device, seed: int) -> dict:
    """The product's high-res finetune (configs/finetune_1024.yaml:
    576x1024x16f, batch 1, the full-width WorldModel in bf16, synthetic
    data) through the trainer for two steps with a sample grid at step 2
    and the TensorBoard and CSV loggers: once as it is, once under
    PANDORA_FINE_REMAT. Per run the steps' seconds, the peak memory of each
    part (a step's data, encoders, forward and backward; its clip and
    AdamW; the sample) and of the run, loss, gradient norm and launches
    against the routing; the two runs' first losses agree."""
    from open_pandora_tpu_torch.core import flags
    from open_pandora_tpu_torch.core.config import PandoraConfig, load_config
    from open_pandora_tpu_torch.train import trainer
    from open_pandora_tpu_torch.train.optim import Optimizer

    cfg = PandoraConfig()
    hcfg = load_config([HIRES_CONFIG])
    h, w = hcfg.train.height, hcfg.train.width
    plen = llm_prompt_len(cfg)
    sample = predicted_launches(cfg, h, w, 10, frame_chunk=1, fused=True)
    reports, total = [], dict.fromkeys(KERNEL_KEYS, 0)
    real_sample, real_opt = trainer.sample_grid, Optimizer.step
    for fine in (False, True):
        step = predicted_llm_stage_launches(cfg, "finetune", h, w, 1, plen,
                                            fine_remat=fine)
        want = {k: HIRES_STEPS * step[k] + sample[k] for k in KERNEL_KEYS}
        peaks, sample_s = [], []

        def peak_since(part):
            """The peak since the last reading, named, then reset."""
            torch.cuda.synchronize()
            peaks.append((part, torch.cuda.max_memory_allocated()))
            torch.cuda.reset_peak_memory_stats()

        def opt_spy(self):
            peak_since("forward_backward")
            out = real_opt(self)
            peak_since("optimizer")
            return out

        def sample_spy(*a, **kw):
            peak_since("between")
            t0 = time.perf_counter()
            out = real_sample(*a, **kw)
            peak_since("sample")
            sample_s.append(time.perf_counter() - t0)
            return out
        logdir = tempfile.mkdtemp(prefix="chip_smoke_hires_")
        trainer.sample_grid, Optimizer.step = sample_spy, opt_spy
        try:
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            with flags.overridden(FINE_REMAT=fine):
                trainer.run([
                    "--config", HIRES_CONFIG, "--synthetic-data",
                    "--max-steps", str(HIRES_STEPS),
                    "--sample-every", str(HIRES_STEPS),
                    "--logger", "tensorboard,csv",
                    "--set", "train.log_every=1", "--device", "cuda",
                    "--logdir", logdir, "--name", "phase10"])
            torch.cuda.synchronize()
            launches = read_launches()
            loginfo = os.path.join(logdir, "phase10", "loginfo")
            with open(os.path.join(loginfo, "metrics.jsonl")) as f:
                recs = [json.loads(line) for line in f]
            with open(os.path.join(loginfo, "metrics.csv")) as f:
                csv_rows = f.read().strip().splitlines()[1:]
            tb = os.path.join(loginfo, "tb")
            events = [os.path.join(tb, n) for n in os.listdir(tb)]
            grid = png_size(os.path.join(
                loginfo, f"sample_step{HIRES_STEPS}.png"))
            rep = {
                "fine_remat": fine, "resolution": [h, w],
                "sec_per_step": [r["sec_per_step"] for r in recs],
                "loss": [r["loss"] for r in recs],
                "grad_norm": [r["grad_norm"] for r in recs],
                "peak_by_part": peaks,
                "max_memory_allocated_steps": max(
                    v for k, v in peaks if k != "sample"),
                "max_memory_allocated": max(
                    [v for _, v in peaks]
                    + [torch.cuda.max_memory_allocated()]),
                "sample_s": sample_s, "sample_grid_hw": grid,
                "csv_rows": len(csv_rows), "tfevents_files": len(events),
                "tfevents_crc_ok": (len(events) == 1
                                    and tfevents_first_record_ok(events[0])),
                "launches": launches, "predicted": want}
        finally:
            trainer.sample_grid, Optimizer.step = real_sample, real_opt
            shutil.rmtree(logdir, ignore_errors=True)
            torch.cuda.empty_cache()
        log("train_hires", json.dumps(rep))
        finite = all(np.isfinite(r[k]) for r in recs
                     for k in ("loss", "grad_norm"))
        if len(recs) != HIRES_STEPS or not finite:
            raise AssertionError(f"bad metrics {recs}")
        if grid != (h, 8 * w):
            raise AssertionError(f"sample grid {grid}, want {(h, 8 * w)}")
        if rep["csv_rows"] != HIRES_STEPS or not rep["tfevents_crc_ok"]:
            raise AssertionError(f"bad logger files {rep}")
        if launches != want:
            raise AssertionError(f"launches {launches} != {want}")
        reports.append(rep)
        for k in KERNEL_KEYS:
            total[k] += launches[k]
    READINGS["train_hires"] = {
        "sec_per_step": reports[0]["sec_per_step"],
        "max_memory_allocated_steps": reports[0]["max_memory_allocated_steps"]}
    l0, l1 = reports[0]["loss"][0], reports[1]["loss"][0]
    if not abs(l1 - l0) <= 1e-3 * abs(l0):
        raise AssertionError(f"first losses {l0} and {l1} differ")
    if min(total[k] for k in HIRES_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


# -- phase 11: the parallel layer over a world-size-1 NCCL group -------------

MULTI_KEYS = ("flash", "flash_bwd", "small", "small_bwd", "packed",
              "fused_temporal", "group_norm")
MULTI_STEPS = 4
TP_ROWS = 1024      # the LLaMA prefill under TP: on the flash route (>= 512)
# held to the one-device call: the forward paths by 1e-3 of the reference's
# largest |value| (the same kernels on the same inputs: expected 0); the
# train step's loss by 1e-3 of itself, its gradient norm by 1e-2 (its
# square summed from the shards), each updated parameter by 2 lr plus one
# bf16 step of the largest (a sign flip of a tiny gradient; a last-bit
# change of the update rounding the bf16 parameter the other way). The
# ring prefill's 384 rows take the flash kernel per block where the
# one-device trunk takes the plain route (below 512 rows), so it is held
# by phase 3's rule to the trunk in fp32: within twice the bf16 trunk's
# distance from it plus 1% of its mean |value|.
MULTI_FWD_REL = 1e-3
MULTI_LOSS_REL, MULTI_NORM_REL = 1e-3, 1e-2


def run_multi(seed: int, prompt: torch.Tensor) -> dict:
    """Phase 11 in a process of its own (the group needs torchrun's
    environment); returns the parallel paths' launches."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    work = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    try:
        prompt_path = os.path.join(work, "prompt.pt")
        out_path = os.path.join(work, "report.json")
        torch.save(prompt, prompt_path)
        env = {**os.environ, "RANK": "0", "LOCAL_RANK": "0",
               "WORLD_SIZE": "1", "MASTER_ADDR": "localhost",
               "MASTER_PORT": str(port)}
        t0 = time.perf_counter()
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--seed", str(seed), "--multi-worker", out_path,
                        prompt_path], env=env, check=True, timeout=600)
        with open(out_path) as f:
            out = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log("multi", f"phase 11 process: {time.perf_counter() - t0:.1f} s")
    return out["launches"]


def _measured(fn):
    """(fn(), wall s, peak bytes, launches) of one call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0, torch.cuda.max_memory_allocated(),
            read_launches())


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _pair(name: str, ref: tuple, got: tuple, extra: dict) -> dict:
    """Log one path against its one-device call; the launches must be
    the one-device call's unless the path's routing differs (extra)."""
    rec = {"path": name, "wall_s": got[1], "one_device_wall_s": ref[1],
           "peak_bytes": got[2], "one_device_peak_bytes": ref[2],
           "launches": got[3], "one_device_launches": ref[3], **extra}
    log("multi", json.dumps(rec))
    return rec


def multi_worker(out_path: str, prompt_path: str, seed: int) -> int:
    """Phase 11's body (in the process run_multi starts)."""
    import dataclasses

    import torch.distributed as dist

    from open_pandora_tpu_torch.core.config import PandoraConfig, load_config
    from open_pandora_tpu_torch.eval.inference import build_model
    from open_pandora_tpu_torch.models.encoders import empty_prompt_tokens
    from open_pandora_tpu_torch.ops import kernels
    from open_pandora_tpu_torch.parallel.launch import init_distributed
    from open_pandora_tpu_torch.parallel.mesh import build_mesh
    from open_pandora_tpu_torch.parallel.sharded_infer import (
        sharded_decode, sharded_synthesis)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    kernels.library()
    if not init_distributed("cuda"):
        raise AssertionError("init_distributed opened no group")
    log("multi", f"group: backend {dist.get_backend()}, world "
        f"{dist.get_world_size()}, rank {dist.get_rank()}, device "
        f"cuda:{torch.cuda.current_device()}; {card_line()}")
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError("phase 11 runs one NCCL rank")
    cfg = PandoraConfig()
    fcfg = load_config(["configs/finetune.yaml"])
    ms = build_mesh(fcfg.mesh)
    launches = dict.fromkeys(KERNEL_KEYS, 0)
    report = {"card": card_line(), "mesh": dataclasses.asdict(fcfg.mesh)}

    def count(rec):
        for k in KERNEL_KEYS:
            launches[k] += rec[3][k]

    try:
        h, w = cfg.train.height, cfg.train.width
        model = build_model(cfg, device=device, dtype=torch.bfloat16,
                            generator=torch.Generator(device=device)
                            .manual_seed(seed + 21))
        rng = np.random.default_rng(seed + 22)
        image = torch.from_numpy(rng.random((1, h, w, 3), np.float32)
                                 ).to(device)
        with torch.no_grad():
            text = model.encode_text(empty_prompt_tokens(
                1, cfg.clip_text.context_length, device=device))
        kw = dict(text_context=text, cond_images=image,
                  cond_frames=image[:, None] * 2 - 1, ddim_steps=MULTI_STEPS,
                  guidance_scale=7.5, guidance_rescale=0.7, fs=3)

        def synth(fn):
            with torch.no_grad():
                return fn(**kw, generator=torch.Generator(device=device)
                          .manual_seed(seed))
        synth(model.image_guided_synthesis)                    # warm-up
        ref = _measured(lambda: synth(model.image_guided_synthesis))
        got = _measured(lambda: synth(
            lambda **a: sharded_synthesis(model, ms, **a)))
        count(got)
        d = _max_abs(got[0], ref[0])
        report["synthesis"] = _pair("sharded_synthesis", ref, got, {
            "max_abs_diff": d, "scale": ref[0].abs().max().item()})
        if not d <= MULTI_FWD_REL * ref[0].abs().max().item() or \
                got[3] != ref[3]:
            raise AssertionError("sharded_synthesis != one device")
        z = ref[0]
        with torch.no_grad():
            ref = _measured(lambda: model.decode(z, frame_chunk=8))
            got = _measured(lambda: sharded_decode(model, ms, z,
                                                   frame_chunk=8))
        count(got)
        d = _max_abs(got[0], ref[0])
        report["decode"] = _pair("sharded_decode", ref, got, {
            "max_abs_diff": d, "shape": list(got[0].shape)})
        if not d <= MULTI_FWD_REL * ref[0].abs().max().item() or \
                got[3] != ref[3]:
            raise AssertionError("sharded_decode != one device")
        del z, ref, got

        report["train"] = _multi_train(model, fcfg, ms, seed, count)
        del model
        torch.cuda.empty_cache()
        report["trainer"] = _multi_trainer(seed, count)
        report["llama"] = _multi_llama(device, cfg, seed, prompt_path,
                                       count)
    finally:
        dist.destroy_process_group()
    missing = [k for k in MULTI_KEYS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels of the path never launched: {missing}")
    report["launches"] = launches
    log("multi", json.dumps({"launches": launches}))
    with open(out_path, "w") as f:
        json.dump({"launches": launches, "report": report}, f)
    return 0


def _multi_train(model, fcfg, ms, seed: int, count) -> dict:
    """The dynamicrafter step (finetune.yaml's train settings, batch 1 at
    320x512x16f, dropout off) on one device, under the mesh with ZeRO-2,
    and with FSDP, from the same weights, batch and draws."""
    import dataclasses

    from open_pandora_tpu_torch.data.webvid import (PrefetchLoader,
                                                    SyntheticVideoDataset)
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_finetune_step)
    from torch.distributed.tensor import DTensor

    cfg = model.cfg
    tcfg = dataclasses.replace(fcfg.train, stage="dynamicrafter")
    zero_dropout_(model)
    batch = next(iter(PrefetchLoader(SyntheticVideoDataset(
        video_length=tcfg.video_length, resolution=(tcfg.height, tcfg.width),
        clip_size=cfg.clip_vision.image_size), 1,
        text_len=cfg.clip_text.context_length).epoch(0)))
    init = {k: v.clone() for k, v in model.state_dict().items()}

    def run(mesh_spec, fsdp):
        model.load_state_dict(init)
        step = make_finetune_step(model, tcfg, mesh_spec=mesh_spec,
                                  fsdp=fsdp)
        state = TrainState.create(model, "dynamicrafter", tcfg)
        if mesh_spec is not None:
            state = step.shard_state(state)
        gen = torch.Generator(device=model.device).manual_seed(seed + 23)
        rec = _measured(lambda: step(state, batch, generator=gen))
        params = {k: p.full_tensor() if isinstance(p, DTensor) else
                  p.detach().clone() for k, p in state.trainable.items()}
        metrics = {k: float(v) for k, v in rec[0].items()}
        kinds = [s.kind for s in state.optimizer.slots]
        del state, step
        torch.cuda.empty_cache()
        return (metrics, *rec[1:]), params, {
            k: kinds.count(k) for k in ("rep", "shard", "fsdp")}

    run(None, False)                                           # warm-up
    ref, ref_params, _ = run(None, False)
    top = max(p.abs().max().item() for p in ref_params.values())
    bound = 2 * tcfg.learning_rate + top * 2.0 ** -7
    # held on the host, so that the mesh steps' peaks are comparable to the
    # one-device step's
    ref_params = {k: v.cpu() for k, v in ref_params.items()}
    torch.cuda.empty_cache()
    out = {"one_device": ref[0]}
    for name, fsdp in (("zero2", False), ("fsdp", True)):
        got, params, kinds = run(ms, fsdp)
        count(got)
        d = max(_max_abs(params[k], v.to(params[k].device))
                for k, v in ref_params.items())
        del params
        m, r = got[0], ref[0]
        out[name] = _pair(f"train_{name}", ref, got, {
            "metrics": m, "slots": kinds, "param_max_abs_diff": d,
            "param_bound": bound})
        if (abs(m["loss"] - r["loss"]) > MULTI_LOSS_REL * r["loss"]
                or abs(m["grad_norm"] - r["grad_norm"])
                > MULTI_NORM_REL * r["grad_norm"] or d > bound
                or got[3] != ref[3]
                # one data rank: ZeRO-2 shards nothing, FSDP holds DTensors
                or (not kinds["fsdp"] if fsdp else kinds["shard"] > 0)):
            raise AssertionError(f"train step {name} != one device")
    return out


MULTI_TRAIN_STEPS = 2


def _multi_trainer(seed: int, count) -> dict:
    """train.trainer.run inside the group: configs/finetune.yaml (its mesh,
    ZeRO-2 over the data axis) at stage dynamicrafter, synthetic data,
    2 steps into a temporary logdir; rank 0 writes the metrics and the
    final checkpoint."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.train import trainer

    logdir = tempfile.mkdtemp(prefix="chip_smoke_multi_train_")
    try:
        rec = _measured(lambda: trainer.run([
            "--config", "configs/finetune.yaml", "--synthetic-data",
            "--max-steps", str(MULTI_TRAIN_STEPS), "--logdir", logdir,
            "--name", "multi", "--device", "cuda", "--logger", "none",
            "--set", "train.stage=dynamicrafter",
            "--set", "train.log_every=1", "--set", f"train.seed={seed}"]))
        state = rec[0]
        mesh = state.optimizer.mesh
        kinds = [sl.kind for sl in state.optimizer.slots]
        step = state.step
        del state
        torch.cuda.empty_cache()
        ws = os.path.join(logdir, "multi")
        with open(os.path.join(ws, "loginfo", "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        ckpts = sorted(os.listdir(os.path.join(ws, "checkpoints")))
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    count(rec)
    cfg = PandoraConfig()
    want = predicted_train_launches(cfg, cfg.train.height, cfg.train.width,
                                    batch=1,
                                    frames=cfg.train.video_length + 1,
                                    bf16=True)
    out = {"path": "trainer_run", "steps": step, "wall_s": rec[1],
           "peak_bytes": rec[2], "launches": rec[3],
           "mesh": [mesh.n_data, mesh.n_model], "checkpoints": ckpts,
           "loss": [r["loss"] for r in recs],
           "grad_norm": [r["grad_norm"] for r in recs]}
    log("multi", json.dumps(out))
    if mesh is None or mesh.data_group is None:
        raise AssertionError("the trainer's optimizer holds no data group")
    if (step != MULTI_TRAIN_STEPS or len(recs) != MULTI_TRAIN_STEPS
            or ckpts != [f"step_{MULTI_TRAIN_STEPS}"]
            or not all(np.isfinite(r[k]) for r in recs
                       for k in ("loss", "grad_norm"))):
        raise AssertionError(f"bad trainer run {out}")
    if kinds.count("rep") != len(kinds):
        raise AssertionError(f"one data rank sharded a leaf: {kinds}")
    if rec[3] != {k: MULTI_TRAIN_STEPS * want[k] for k in KERNEL_KEYS}:
        raise AssertionError(f"launches {rec[3]} != {MULTI_TRAIN_STEPS} x "
                             f"{want}")
    return out


def _multi_llama(device, cfg, seed: int, prompt_path: str, count) -> dict:
    """The LLaMA-7B (random weights, bf16) prefill: phase 7's round-2
    prompt on the ring (sp_llama_prefill), then TP_ROWS rows of embedded
    random ids under tensor parallelism, bf16 and then int8, each against
    the one-device trunk."""
    from open_pandora_tpu_torch.core.config import MeshConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
    from open_pandora_tpu_torch.models.quant import quantize_llama_
    from open_pandora_tpu_torch.parallel.mesh import build_mesh
    from open_pandora_tpu_torch.parallel.sp import sp_llama_prefill
    from open_pandora_tpu_torch.parallel.tp import shard_llama_

    with torch.device("meta"):
        llama = LlamaForCausalLM(cfg.llama)
    llama = llama.to(torch.bfloat16).to_empty(device=device).eval()
    init_random_(llama, torch.Generator(device=device).manual_seed(seed + 24))
    ms = build_mesh(MeshConfig())
    out = {}
    with torch.no_grad():
        prompt = torch.load(prompt_path).to(device)
        llama.trunk(prompt)                                    # warm-up
        ref = _measured(lambda: llama.trunk(prompt))
        got = _measured(lambda: sp_llama_prefill(llama, prompt, ms=ms))
        count(got)
        llama.float()     # bf16 -> fp32 -> bf16 is exact
        ref32 = llama.trunk(prompt)
        llama.to(torch.bfloat16)
        err, bound = _kernel_bound(got[0], ref[0], ref32)
        out["sp"] = _pair("sp_llama_prefill", ref, got, {
            "rows": prompt.shape[1], "max_abs_diff": _max_abs(got[0], ref[0]),
            "max_abs_err_fp32": err, "one_device_err_fp32":
            _max_abs(ref[0], ref32), "bound": bound,
            "scale": ref32.abs().max().item()})
        del ref32
        n_layers = cfg.llama.num_layers
        if not err <= bound or got[3]["flash"] != n_layers:
            raise AssertionError("sp_llama_prefill out of bound")
        ids = torch.randint(0, cfg.llama.vocab_size, (1, TP_ROWS),
                            generator=torch.Generator(device=device)
                            .manual_seed(seed + 25), device=device)
        emb = llama.embed(ids)
        ref = _measured(lambda: llama.trunk(emb))
        shard_llama_(ms, llama)
        got = _measured(lambda: llama.trunk(emb))
        count(got)
        d = _max_abs(got[0], ref[0])
        out["tp"] = _pair("tp_prefill", ref, got, {
            "rows": TP_ROWS, "max_abs_diff": d,
            "scale": ref[0].abs().max().item()})
        if not d <= MULTI_FWD_REL * ref[0].abs().max().item() or \
                got[3] != ref[3] or got[3]["flash"] != n_layers:
            raise AssertionError("TP prefill != one device")
        # the int8 layout (column weights and scales split, row weights
        # split with scales whole) on the same weights, quantized on the card
        del llama, ref, got
        torch.cuda.empty_cache()
        with torch.device("meta"):
            llama = LlamaForCausalLM(cfg.llama)
        llama = llama.to(torch.bfloat16).to_empty(device=device).eval()
        init_random_(llama,
                     torch.Generator(device=device).manual_seed(seed + 24))
        quantize_llama_(llama, "int8")
        ref = _measured(lambda: llama.trunk(emb))
        shard_llama_(ms, llama)
        got = _measured(lambda: llama.trunk(emb))
        count(got)
        d = _max_abs(got[0], ref[0])
        out["tp_int8"] = _pair("tp_int8_prefill", ref, got, {
            "rows": TP_ROWS, "max_abs_diff": d,
            "scale": ref[0].abs().max().item()})
        if not d <= MULTI_FWD_REL * ref[0].abs().max().item() or \
                got[3] != ref[3] or got[3]["flash"] != n_layers:
            raise AssertionError("int8 TP prefill != one device")
    return out


# -- phase 12: decoding, the quantized LLaMA, the answer runners, EVA -----------

DECODE_KEYS = EVAL_KEYS         # the prefill (row 1) and the quantized round
DECODE_ROWS = 512     # phase 7's 384-row round-2 prompt + 128 text rows:
                      # the flash gate (512 rows) takes the prefill
DECODE_TOKENS = 32
DECODE_CHECK_STEPS = 8
QUANT_STEPS = 4
QA_NEW_TOKENS = 16
EVA_CONFIG = dict(width=1408, layers=39, heads=16, tower_type="eva_vit_g",
                  mlp_ratio=4.3637)
# the records' fields, as the JAX package's runners write them
QA_FIELDS = {"id", "question", "answer"}
SQA_FIELDS = {"question_id", "prompt", "text", "answer_id", "model_id",
              "pred", "metadata"}
CONSISTENCY_FIELDS = {"video_name", "prompt_1", "text_1", "prompt_2",
                      "text_2", "answer_id", "model_id", "answer", "metadata"}


def _llama_7b(device, seed: int, quantize=False):
    """LLaMAConfig() in bf16 with random weights from `seed` on the card,
    then quantized there (the weights are the same for every mode).
    Returns the model and a record: the float weights' bytes, the seconds
    and the peak bytes of the quantization."""
    from open_pandora_tpu_torch.core.config import LLaMAConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
    from open_pandora_tpu_torch.models.quant import (quantize_llama_,
                                                     tree_nbytes)

    with torch.device("meta"):
        llama = LlamaForCausalLM(LLaMAConfig())
    llama = llama.to(torch.bfloat16).to_empty(device=device).eval()
    init_random_(llama, torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rec = {"float_bytes": tree_nbytes(llama)}
    t0 = time.perf_counter()
    quantize_llama_(llama, quantize)
    torch.cuda.synchronize()
    rec.update(quantize_s=time.perf_counter() - t0,
               quantize_peak_bytes=torch.cuda.max_memory_allocated())
    # each float weight is freed as it is quantized: the peak stays near
    # the float model's bytes, never the float and the quantized model's
    if quantize and rec["quantize_peak_bytes"] > 1.2 * rec["float_bytes"]:
        raise AssertionError(f"quantizing peaked at "
                             f"{rec['quantize_peak_bytes']} B")
    return llama, rec


def decode_launches(llama, tok, pos: int, cache) -> dict:
    """The device operations (kernels, copies, memsets) of one decode
    step, from torch.profiler (None where it shows no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from open_pandora_tpu_torch.models.llama_generate import decode_step

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_step(llama, tok, pos, cache)
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    return {"device_ops_per_token": ops or None}


def _decode_mode(device, seed: int, mode, prompt: torch.Tensor,
                 ids: torch.Tensor, count) -> tuple:
    """One LLaMA-7B mode on phase 7's prompt followed by the embedded
    `ids`: weight bytes, greedy_generate's prefill and its decode loop
    (run twice on the one cache) timed apart with CUDA events, launches
    per token, peaks, first-token logits."""
    from open_pandora_tpu_torch.models.llama_generate import (
        decode_tokens, greedy_generate, prefill_cache)
    from open_pandora_tpu_torch.models.quant import tree_nbytes

    llama, rec = _llama_7b(device, seed, mode)
    rec = {"mode": mode or "bf16", "weight_bytes": tree_nbytes(llama), **rec}
    with torch.no_grad():
        prompt = torch.cat([prompt.to(device, torch.bfloat16),
                            llama.embed(ids.to(device))], 1)
        L = prompt.shape[1]
        greedy_generate(llama, prompt, max_new_tokens=2)        # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        # greedy_generate, split at the end of its prefill
        ev[0].record()
        last, cache = prefill_cache(llama, prompt, L + DECODE_TOKENS)
        first = llama.lm_head(last)
        tok0 = first.argmax(dim=-1)
        ev[1].record()
        torch.cuda.synchronize()
        prefill_launches = read_launches()
        runs = []
        for a, b in ((2, 3), (4, 5)):
            ev[a].record()
            runs.append(decode_tokens(llama, tok0, cache, L, DECODE_TOKENS))
            ev[b].record()
        torch.cuda.synchronize()
        got = read_launches()
        count(got)
        # DECODE_TOKENS - 1 decode steps a run
        per_token = [ev[a].elapsed_time(ev[b]) / (DECODE_TOKENS - 1)
                     for a, b in ((2, 3), (4, 5))]
        toks = runs[0]
        rec.update(
            prefill_rows=L, prefill_ms=ev[0].elapsed_time(ev[1]),
            tokens=DECODE_TOKENS, ms_per_token=sum(per_token) / 2,
            ms_per_token_runs=per_token,
            ms_per_token_spread=abs(per_token[0] - per_token[1]),
            runs_agree=bool(torch.equal(runs[0], runs[1])),
            peak_bytes=torch.cuda.max_memory_allocated(),
            prefill_flash_launches=prefill_launches["flash"],
            launches=got, first_tokens=toks[0, :8].tolist(),
            **decode_launches(llama, toks[:, 0], L, cache))
        first = first.float()
    rec["weight_bound_ms_per_token"] = (rec["weight_bytes"] / HBM_BYTES_PER_S
                                        * 1e3)
    return rec, llama, first, prompt


def _decode_against_naive(llama, prompt: torch.Tensor) -> dict:
    """The KV decode's logits at its first steps against a re-prefill of
    prompt + tokens, both in bf16, held by phase 3's rule to the
    re-prefill in fp32: within twice the bf16 re-prefill's distance from
    it plus 1% of its mean |value|. The fp32 re-prefill passes an
    all-True attention mask, which sends it to the plain attention route:
    the reference launches no kernel."""
    from open_pandora_tpu_torch.models.llama_generate import (decode_step,
                                                              prefill_cache)

    L, n = prompt.shape[1], DECODE_CHECK_STEPS
    with torch.no_grad():
        last, cache = prefill_cache(llama, prompt, L + n)
        tok = llama.lm_head(last).argmax(-1)
        toks, kv = [], []
        for i in range(n):
            toks.append(tok)
            kv.append(decode_step(llama, tok, L + i, cache).float())
            tok = kv[-1].argmax(-1)
        seq = torch.cat([prompt, llama.embed(torch.stack(toks, 1))], 1)

        def naive(mask=None):
            h = llama.trunk(seq, attention_mask=mask)
            return [llama.lm_head(h[:, L + i]).float() for i in range(n)]
        bf = naive()
        llama.float()          # bf16 -> fp32 -> bf16 is exact
        seq = seq.float()
        ref = naive(torch.ones(seq.shape[:2], dtype=torch.bool,
                               device=seq.device))
        llama.to(torch.bfloat16)
    worst, ok = [], True
    for a, b, r in zip(kv, bf, ref):
        err = (a - r).abs().max().item()
        bound = 2 * (b - r).abs().max().item() + 1e-2 * r.abs().mean().item()
        worst.append({"err": err, "bound": bound,
                      "kv_vs_bf16_naive": (a - b).abs().max().item()})
        ok &= err <= bound
    return {"steps": n, "ok": ok, "by_step": worst}


def run_decode(device, seed: int, prompt: torch.Tensor) -> dict:
    """Phase 12; `prompt` is phase 7's round-2 prompt (1, 384, 4096).
    Returns the launches of its main-path runs."""
    total = dict.fromkeys(KERNEL_KEYS, 0)

    def count(got):
        for k in KERNEL_KEYS:
            total[k] += got[k]

    t_phase = time.perf_counter()
    card = card_line()
    # 1. LLaMA-7B in bf16, int8 and NF4, one at a time, on one prompt
    ids = torch.randint(3, 32000, (1, DECODE_ROWS - prompt.shape[1]),
                        generator=torch.Generator().manual_seed(seed + 30))
    firsts, recs = {}, []
    for mode in (False, "int8", "nf4"):
        t0 = time.perf_counter()
        rec, llama, first, full = _decode_mode(device, seed + 31, mode,
                                               prompt, ids, count)
        firsts[rec["mode"]] = first
        if mode is False:
            rec["decode_vs_naive"] = _decode_against_naive(llama, full)
        rec["wall_s"] = time.perf_counter() - t0
        rec["card"] = card
        recs.append(rec)
        log("decode", json.dumps(rec))
        if not bool(torch.isfinite(first).all()) or \
                rec["prefill_flash_launches"] != len(llama.model.layers):
            raise AssertionError(f"{rec['mode']}: non-finite logits or "
                                 "a prefill off the flash route")
        del llama, full
        torch.cuda.empty_cache()
    ref = firsts["bf16"]
    errs = {m: (firsts[m] - ref).abs().max().item() / ref.abs().max().item()
            for m in ("int8", "nf4")}
    log("decode", json.dumps({"first_token_logits_rel_err_vs_bf16": errs,
                              "card": card}))
    if not recs[0]["decode_vs_naive"]["ok"]:
        raise AssertionError("KV decode != re-prefill by the bf16 rule")

    # 2. the quantized session: cli.build_chat --quantize-llm, two actions
    quant = run_quant_session(device, seed, count)
    # 3. the answer runners' cores on the full-width WorldModel (bf16)
    qa = run_runners(device, seed)
    # 4. EVA-ViT-g at full width
    eva = run_eva(device, seed)
    log("decode", json.dumps({
        "phase_s": time.perf_counter() - t_phase, "launches": total,
        "card": card, "session": quant, "runners_s": qa, "eva": eva}))
    if min(total[k] for k in DECODE_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


def run_quant_session(device, seed: int, count) -> dict:
    """cli.build_chat with --quantize-llm (int8) at 320x512, cli.run of
    two actions at DDIM-4: seconds by part, launches against the routing,
    peak; then the last round's conditioning with an NF4 LLaMA."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.models.quant import tree_nbytes
    from open_pandora_tpu_torch.pipeline import cli

    cfg = PandoraConfig()
    argv = ["--image", "unused.png", "--action", ENTRY_ACTIONS[0],
            "--action", ENTRY_ACTIONS[1], "--ddim-steps", str(QUANT_STEPS),
            "--seed", str(seed)]
    out = {}
    for mode in ("int8", "nf4"):
        args = cli.build_parser().parse_args(argv + ["--quantize-llm", mode])
        t0 = time.perf_counter()
        chat = cli.build_chat(args)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        rec = {"mode": mode, "built_s": built,
               "llama_bytes": tree_nbytes(chat.wm.llama.model.layers)
               + tree_nbytes(chat.wm.llama.lm_head),
               "world_bytes": tree_nbytes(chat.wm),
               "allocated_after_build": torch.cuda.memory_allocated()}
        if mode == "int8":
            image = np.random.default_rng(seed + 20).integers(
                0, 256, (360, 640, 3), dtype=np.uint8)
            want = {k: sum(predicted_round(cfg, args.height, args.width,
                                           QUANT_STEPS, c)[k]
                           for c in (1, 4)) for k in KERNEL_KEYS}
            reset_launches()
            frames = cli.run(chat, image, args)
            got = read_launches()
            count(got)
            prompt = chat.prompt
            with torch.no_grad():
                cond_int8 = chat.wm.get_diffusion_conditioning(prompt)
            rec.update(rounds=[dict(r) for r in chat.round_times],
                       frames=list(frames.shape), std=float(frames.std()),
                       launches=got, predicted=want,
                       peak_bytes=torch.cuda.max_memory_allocated())
            if got != want:
                raise AssertionError(f"int8 session: launches {got} != "
                                     f"{want}")
            if frames.shape != (2 * cfg.unet.temporal_length - 4, args.height,
                                args.width, 3) or float(frames.std()) == 0.0:
                raise AssertionError(f"bad frames {frames.shape}")
        else:
            images = prompt.images
            with torch.no_grad():
                t1 = time.perf_counter()
                cond = chat.wm.get_diffusion_conditioning(prompt)
                torch.cuda.synchronize()
            rec.update(
                conditioning_s=time.perf_counter() - t1,
                peak_bytes=torch.cuda.max_memory_allocated(),
                prompt_images=list(images.shape),
                rel_diff_vs_int8=((cond.float() - cond_int8.float())
                                  .abs().max() / cond_int8.float().abs().max()
                                  ).item())
            if not bool(torch.isfinite(cond).all()) or \
                    cond.shape != cond_int8.shape:
                raise AssertionError("NF4 conditioning not finite")
        log("decode", json.dumps(rec))
        out[mode] = rec
        del chat
        torch.cuda.empty_cache()
    return out


def run_runners(device, seed: int) -> dict:
    """The answer runners' cores on the full-width WorldModel (bf16 LLaMA,
    random weights): an image question and a 16-frame video question
    (chatunivi_qa), a two-stage question with letters (scienceqa), a
    sample of two questions (consistency); each record has the JAX
    runner's fields."""
    from open_pandora_tpu_torch.eval import chatunivi_qa, consistency, \
        scienceqa

    t0 = time.perf_counter()
    wm, tok, _, _ = chatunivi_qa.setup_model(device="cuda")
    torch.cuda.synchronize()
    times = {"built_s": time.perf_counter() - t0}
    rng = np.random.default_rng(seed + 32)
    image = rng.integers(0, 256, (360, 640, 3), dtype=np.uint8)
    frames = rng.integers(0, 256, (16, 240, 320, 3), dtype=np.uint8)
    calls = [
        ("qa_image", QA_FIELDS, lambda: chatunivi_qa.answer_question(
            wm, tok, {"id": 1, "text": "What is in the image?"}, image,
            QA_NEW_TOKENS)),
        ("qa_video", QA_FIELDS, lambda: chatunivi_qa.answer_question(
            wm, tok, {"question_id": 2, "question": "What happens?"},
            frames, QA_NEW_TOKENS)),
        ("scienceqa", SQA_FIELDS, lambda: scienceqa.answer_question(
            wm, tok, {"id": "s1", "conversations": [{"value": (
                "<image>\nWhich is a vehicle? (A) a car (B) a tree "
                "(C) a cloud")}]}, image, max_new_tokens=QA_NEW_TOKENS)),
        ("consistency", CONSISTENCY_FIELDS, lambda: consistency.answer_sample(
            wm, tok, {"video_name": "v0", "Q1": "What moves?",
                      "Q2": "What is moving in the video?", "A": "a car"},
            frames, 0, max_new_tokens=QA_NEW_TOKENS))]
    for name, fields, call in calls:
        t1 = time.perf_counter()
        rec = call()
        torch.cuda.synchronize()
        times[name + "_s"] = time.perf_counter() - t1
        log("decode", json.dumps({"runner": name, "record": rec}))
        texts = [rec[k] for k in ("answer", "text", "text_1", "text_2")
                 if k in rec]
        if set(rec) != fields or not all(texts):
            raise AssertionError(f"{name}: record {rec}")
    del wm
    torch.cuda.empty_cache()
    return times


def run_eva(device, seed: int) -> dict:
    """EVA-ViT-g at full width (1408 wide, 39 blocks, 16 heads of 88),
    bf16, random weights, on 1 and 17 images: ms (CUDA events) and peak;
    then phase 4's narrow WorldModel with the EVA tower and with the text
    transformer over the connector, card against CPU in fp32."""
    from open_pandora_tpu_torch.core.config import CLIPTowerConfig
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.eva_tower import EVAVisionTower

    cfg = CLIPTowerConfig(**EVA_CONFIG)
    with torch.device("meta"):
        tower = EVAVisionTower(cfg)
    tower = tower.to(torch.bfloat16).to_empty(device=device).eval()
    init_random_(tower, torch.Generator(device=device).manual_seed(seed + 33))
    out = {"parameters": sum(p.numel() for p in tower.parameters()),
           "blocks_run": tower.n_run}
    for n in (1, 17):
        x = torch.randn(n, 224, 224, 3, device=device, dtype=torch.bfloat16,
                        generator=torch.Generator(device=device)
                        .manual_seed(seed + 34))
        with torch.no_grad():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: tower(x), warmup=1, iters=3)
            y = tower(x)
        out[f"images_{n}"] = {"ms": ms, "peak_bytes":
                              torch.cuda.max_memory_allocated(),
                              "shape": list(y.shape)}
        if y.shape != (n, 256, 1408) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"EVA output {y.shape}")
    log("decode", json.dumps({"eva_vit_g": out, "card": card_line()}))
    del tower
    torch.cuda.empty_cache()
    check_world(device, seed, eva_narrow_world_config(), "eva_vit_g")
    check_world(device, seed, text_encoder_narrow_world_config(),
                "diffusion_text_encoder")
    return out


def eva_narrow_world_config():
    import dataclasses
    cfg = narrow_world_config()
    return dataclasses.replace(cfg, clip_tower=dataclasses.replace(
        cfg.clip_tower, tower_type="eva_vit_g", mlp_ratio=4.3637))


def text_encoder_narrow_world_config():
    import dataclasses
    cfg = narrow_world_config()
    return dataclasses.replace(cfg, connector=dataclasses.replace(
        cfg.connector, use_diffusion_text_encoder=True))


# -- phase 13: the last slice's modules: vbench, the tools, the encoders ------

TOOLS_HW = (320, 512)
HIRES_PROBE_HW = (576, 1024)
VBENCH_STEPS = 4
VBENCH_ITEMS = ({"image_name": "0.png",
                 "prompt_en": "a car drives along the coastal road"},
                {"image_name": "1.png",
                 "prompt_en": "a boat sails across the harbour"})
TOOLS_KEYS = EVAL_KEYS      # vbench's rounds; fused_drift, profile_unet
# fused_drift at full width, DDIM-2: the bf16 routes' rel_mean from each
# other, at most twice the first reading (3.76% z, 4.26% frames, NVIDIA
# H100 80GB HBM3, 700 W); and the fused route no farther from the upcast
# fp32 run than DRIFT_BOUND_RATIO times the unfused route is
DRIFT_BOUND_REL = 0.08
DRIFT_BOUND_RATIO = 1.5


def _launched(total: dict) -> dict:
    """Add the launches since the last reset to `total`; return them."""
    got = read_launches()
    for k in KERNEL_KEYS:
        total[k] += got[k]
    reset_launches()
    return got


def run_tools(device, seed: int) -> dict:
    """Phase 13: (a) vbench, (b) fused_drift, (c) profile_unet and clip_ab,
    (d) the alternative encoders, (e) the latent step at 576x1024, (f) an
    activation dump, card against CPU."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(KERNEL_KEYS, 0)
    reset_launches()
    _tools_vbench(device, seed, total)
    _tools_timing(device, total)
    _tools_encoders(device, seed, total)
    _tools_hires(device, total)
    _tools_activations(device, seed, total)
    log("tools", json.dumps({"phase_s": time.perf_counter() - t_phase,
                             "launches": total, "card": card_line()}))
    if min(total[k] for k in TOOLS_KEYS) <= 0:
        raise AssertionError("a kernel of the path never launched")
    return total


def _tools_vbench(device, seed: int, total: dict) -> None:
    """(a) eval.vbench.run on the full-width WorldModel: 2 items x 2
    samples at DDIM-4, then item 0's sample 0 again."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.eval import vbench
    from open_pandora_tpu_torch.pipeline import cli

    args = vbench.build_parser().parse_args(
        ["--vbench-data", "-", "--save-dir", "-", "--n-samples", "2",
         "--ddim-steps", str(VBENCH_STEPS), "--height", str(TOOLS_HW[0]),
         "--width", str(TOOLS_HW[1])])
    cfg = PandoraConfig()
    t0 = time.perf_counter()
    chat = cli.build_chat(args)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 40)
    images = {m["image_name"]: rng.integers(0, 256, (360, 640, 3),
                                            dtype=np.uint8)
              for m in VBENCH_ITEMS}
    clip = predicted_round(cfg, *TOOLS_HW, VBENCH_STEPS, 1)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    clips, frames = [], {}
    t0 = time.perf_counter()
    for name, f in vbench.run(chat, list(VBENCH_ITEMS), images, args):
        torch.cuda.synchronize()
        clips.append({"name": name, "wall_s": time.perf_counter() - t0,
                      **chat.round_times[-1]})
        frames[name] = f
        t0 = time.perf_counter()
    m0 = VBENCH_ITEMS[0]
    again = chat.generate_video(images[m0["image_name"]], m0["prompt_en"],
                                ddim_steps=VBENCH_STEPS, fs=args.fs,
                                guidance_scale=args.ugs, eta=args.eta,
                                seed=0)
    got = _launched(total)
    want = {k: 5 * clip[k] for k in KERNEL_KEYS}
    names = [c["name"] for c in clips]
    n0 = vbench.clip_name(m0["prompt_en"], 0, 2)
    n1 = vbench.clip_name(m0["prompt_en"], 1, 2)
    rep = {"built_s": built, "clips": clips, "names": names,
           "frames": list(again.shape),
           "same_seed_equal": bool(np.array_equal(again, frames[n0])),
           "seeds_0_1_differ": not np.array_equal(frames[n0], frames[n1]),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launches": got, "predicted": want, "card": card_line()}
    log("tools", json.dumps({"vbench": rep}))
    if names != [vbench.clip_name(m["prompt_en"], s, 2)
                 for m in VBENCH_ITEMS for s in range(2)]:
        raise AssertionError(f"vbench names {names}")
    if got != want:
        raise AssertionError(f"vbench launches {got} != {want}")
    if not (rep["same_seed_equal"] and rep["seeds_0_1_differ"]) or \
            again.shape != (cfg.unet.temporal_length, *TOOLS_HW, 3):
        raise AssertionError(f"vbench frames {rep}")
    del chat
    torch.cuda.empty_cache()


def _tools_timing(device, total: dict) -> None:
    """(b) fused_drift, (c) profile_unet and clip_ab at full width."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.tools import clip_ab, fused_drift, \
        profile_unet

    cfg = PandoraConfig()
    h, w = TOOLS_HW
    t0 = time.perf_counter()
    drift = fused_drift.fused_drift(cfg, device, ddim_steps=2, height=h,
                                    width=w, fp32_reference=True)
    drift.update(wall_s=time.perf_counter() - t0,
                 launches=_launched(total), card=card_line(),
                 bound_rel=DRIFT_BOUND_REL, bound_ratio=DRIFT_BOUND_RATIO)
    log("tools", json.dumps({"fused_drift": drift}))
    ref = drift["fp32_reference"]
    reports = [drift] + [ref[r] for r in ("fused", "unfused")]
    if not all(np.isfinite(v) for rep in reports for k in ("z", "frames")
               for v in rep[k].values()):
        raise AssertionError(f"fused_drift {drift}")
    for k in ("z", "frames"):
        fused, unfused = (ref[r][k]["rel_mean"] for r in ("fused",
                                                          "unfused"))
        if drift[k]["rel_mean"] > DRIFT_BOUND_REL or \
                fused > DRIFT_BOUND_RATIO * unfused:
            raise AssertionError(f"fused_drift {k}: routes {drift[k]}, "
                                 f"from fp32 fused {fused} unfused "
                                 f"{unfused}")
    torch.cuda.empty_cache()
    ev = profile_unet.profile_unet(cfg, device, iters=3, height=h, width=w,
                                   label="phase13")
    ev["launches"] = _launched(total)
    torch.cuda.empty_cache()
    ab = clip_ab.clip_ab(cfg, device, steps_a=2, steps_b=4, height=h,
                         width=w, label="phase13", skip_eval=True)
    ab["launches"] = _launched(total)
    log("tools", json.dumps({
        "profile_unet_ms_per_cfg_eval": ev["ms_per_cfg_eval"],
        "clip_ab_slope_ms_per_step": ab["slope_ms_per_step"],
        "profile_unet": ev, "clip_ab": ab, "card": card_line()}))
    if not (ev["finite"] and ab["finite"]):
        raise AssertionError("profile_unet or clip_ab: non-finite output")
    torch.cuda.empty_cache()


def _encoder_calls(cfgs):
    """(name, module builder, inputs builder) of each alternative encoder
    at the widths of `cfgs` (t5, clip_text, clip_vision)."""
    from open_pandora_tpu_torch.models import encoders_extra as ee

    t5, ct, cv = cfgs

    def ids(vocab, n, b=2, seed=0):
        g = torch.Generator().manual_seed(seed)
        out = torch.randint(1, vocab - 1, (b, n), generator=g)
        out[:, n // 2] = vocab - 1      # the eos: the largest id, once
        return (out,)

    def image(b=2):
        g = torch.Generator().manual_seed(3)
        return (torch.rand((b, 320, 512, 3), generator=g) * 2 - 1,)

    return [
        ("t5", lambda: ee.T5Encoder(t5), lambda: ids(t5.vocab_size, 77)),
        ("clip_text_last", lambda: ee.HFCLIPTextEncoder(ct),
         lambda: ids(ct.vocab_size, ct.context_length)),
        ("clip_text_pooled", lambda: ee.HFCLIPTextEncoder(ct, "pooled"),
         lambda: ids(ct.vocab_size, ct.context_length)),
        ("clip_text_hidden", lambda: ee.HFCLIPTextEncoder(ct, "hidden", -2),
         lambda: ids(ct.vocab_size, ct.context_length)),
        ("pooled_clip_image", lambda: ee.PooledCLIPImageEncoder(cv),
         image),
        ("class_embedder", lambda: ee.ClassEmbedder(1024, ucg_rate=0.0),
         lambda: (torch.arange(0, 1000, 125),)),
    ]


def _tools_encoders(device, seed: int, total: dict) -> None:
    """(d) each alternative encoder at its full-size defaults in bf16 (ms by
    CUDA events, peak), then at narrow widths in fp32, card against CPU
    within BOUND_REL of the scale."""
    from open_pandora_tpu_torch.core import config as c
    from open_pandora_tpu_torch.core.init import init_random_

    full = []
    for name, build, inputs in _encoder_calls(
            (c.T5Config(), c.CLIPTextConfig(), c.CLIPVisionConfig())):
        with torch.device("meta"):
            mod = build()
        mod = mod.to(torch.bfloat16).to_empty(device=device).eval()
        init_random_(mod, torch.Generator(device=device).manual_seed(seed))
        x = [t.to(device) for t in inputs()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            ms = cuda_ms(lambda: mod(*x), warmup=1, iters=3)
            y = mod(*x)
        full.append({"encoder": name, "ms": ms, "shape": list(y.shape),
                     "parameters": sum(p.numel() for p in mod.parameters()),
                     "peak_bytes": torch.cuda.max_memory_allocated()})
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: non-finite output")
        del mod, y
        torch.cuda.empty_cache()
    narrow = []
    for name, build, inputs in _encoder_calls((
            c.T5Config(vocab_size=300, d_model=64, d_kv=16, d_ff=96,
                       num_layers=2, num_heads=4),
            c.CLIPTextConfig(vocab_size=300, width=64, layers=2, heads=2),
            c.CLIPVisionConfig(width=64, layers=2, heads=2))):
        cpu = build().eval()
        init_random_(cpu, torch.Generator().manual_seed(seed))
        card = copy.deepcopy(cpu).to(device)
        x = inputs()
        with torch.no_grad():
            ref = cpu(*x)
            got = card(*[t.to(device) for t in x]).cpu()
        err = (got - ref).abs().max().item()
        scale = max(1.0, ref.abs().max().item())
        narrow.append({"encoder": name, "max_abs_err": err, "scale": scale,
                       "ok": err <= BOUND_REL * scale})
    launches = _launched(total)
    log("tools", json.dumps({"encoders_full_bf16": full,
                             "encoders_narrow_fp32_card_vs_cpu": narrow,
                             "bound_rel": BOUND_REL, "launches": launches,
                             "card": card_line()}))
    if not all(r["ok"] for r in narrow):
        raise AssertionError("an encoder's card and CPU outputs disagree")


def _tools_hires(device, total: dict) -> None:
    """(e) tools.hires_train_probe at 576x1024: precompute, then 2 latent
    steps after a first one with adamw8bit (the probe's default), then
    with adamw (phase 10's), to tell the optimizer's share."""
    from open_pandora_tpu_torch.core.config import PandoraConfig
    from open_pandora_tpu_torch.tools import hires_train_probe

    cfg = PandoraConfig()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_latents_")
    try:
        t0 = time.perf_counter()
        path = hires_train_probe.precompute(
            cfg, device, height=HIRES_PROBE_HW[0], width=HIRES_PROBE_HW[1],
            path=os.path.join(tmp, "latents.npz"))
        pre_s = time.perf_counter() - t0
        reps = []
        # adamw8bit, the probe's default; then adamw, phase 10's optimizer
        for opt in ("adamw8bit", "adamw"):
            torch.cuda.empty_cache()
            rep = hires_train_probe.train(cfg, device, latents=path,
                                          steps=2, optimizer=opt)
            rep.update(launches=_launched(total), card=card_line())
            reps.append(rep)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("tools", json.dumps({"hires_train_probe": reps,
                             "precompute_s": pre_s,
                             "phase10_in_step": READINGS.get("train_hires"),
                             "card": card_line()}))
    if not all(np.isfinite([r["loss_first"], r["loss_last"]]).all()
               for r in reps):
        raise AssertionError(f"latent step losses {reps}")
    torch.cuda.empty_cache()


def _tools_activations(device, seed: int, total: dict) -> None:
    """(f) activation_dump of one fp32 forward of phase 4's narrow UNet on
    an 8x8 latent (the JAX tool's --tiny size; every module's output is
    kept, compressed), card against CPU: diff_npz's rows; the output
    within BOUND_REL."""
    import contextlib
    import io

    from open_pandora_tpu_torch.tools import activation_dump

    ucfg = narrow_config().unet
    tmp = tempfile.mkdtemp(prefix="chip_smoke_acts_")
    try:
        paths = {}
        for name, dev in (("card", device), ("cpu", torch.device("cpu"))):
            acts = activation_dump.dump_unet(ucfg, dev, h=8, w=8,
                                             seed=seed)
            paths[name] = activation_dump.save_npz(
                os.path.join(tmp, name + ".npz"), acts)
        with contextlib.redirect_stdout(io.StringIO()):
            rows = activation_dump.diff_npz(paths["card"], paths["cpu"],
                                            top=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst = max(rows, key=lambda r: r[1])
    out = dict((k, r) for k, r, _ in rows)["__output__"]
    log("tools", json.dumps({"activation_dump": {
        "modules": len(rows), "largest_rel_row": worst[:2],
        "output_rel": out, "bound_rel": BOUND_REL,
        "launches": _launched(total), "card": card_line()}}))
    if not out <= BOUND_REL:
        raise AssertionError(f"activation dump: output {out} from the CPU")


def main(argv=None) -> int:
    p = argparse.ArgumentParser("chip_smoke")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ddim-steps", type=int, default=10)
    # phase 11's own process: the JSON report's path and phase 7's prompt
    p.add_argument("--multi-worker", nargs=2, metavar=("OUT", "PROMPT"),
                   help=argparse.SUPPRESS)
    p.add_argument("--fp32-only", action="store_true",
                   help="phases 1-2, phase 3's fp32 cases (rows 1, 2, 9, "
                   "10, 11, 12, 13), phase 5d and phase 6b, then stop without "
                   "a result line (from a tree whose csrc/ is another "
                   "commit's, this times that commit's kernels by this "
                   "script's cases and rules)")
    args = p.parse_args(argv)
    if args.multi_worker:
        return multi_worker(*args.multi_worker, args.seed)

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

    t_run = time.perf_counter()
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.fp32_only:
        summary = {}
        check_flash(summary, device, gen, dtypes=(torch.float32,))
        check_small(summary, device, gen, dtypes=(torch.float32,))
        check_attention_bwd(summary, device, gen, dtypes=(torch.float32,))
        check_conv(summary, device, gen, dtypes=(torch.float32,))
        check_geglu(summary, device, gen, dtypes=(torch.float32,))
        run_conv_fp32(device, args.seed)
        run_train(device, args.seed, fp32=True)
        log("run", f"wall {time.perf_counter() - t_run:.1f} s (fp32 only)")
        return 0
    summary = check_kernels(device, gen)
    check_model(device, args.seed)
    check_model_bf16(device, args.seed)
    check_model_bf16(device, args.seed, wide_head_narrow_config(),
                     decode=False,
                     must_launch=("dual_cross", "flash", "small", "group_norm"))
    check_train_step(device, args.seed)
    check_world(device, args.seed)
    launches, model = run_slice(device, args.seed, args.ddim_steps)
    paths = {"eval": launches,
             "conv": run_conv_route(device, args.seed, model)}
    del model
    torch.cuda.empty_cache()
    paths["conv_fp32"] = run_conv_fp32(device, args.seed)
    paths["wide_heads"] = run_wide_heads(device, args.seed)
    torch.cuda.empty_cache()
    paths["svd"] = run_svd(device, args.seed)
    torch.cuda.empty_cache()
    paths["train"] = run_train(device, args.seed)
    torch.cuda.empty_cache()
    paths["train_fp32"] = run_train(device, args.seed, fp32=True)
    torch.cuda.empty_cache()
    prompts = []
    paths["world"] = run_world(device, args.seed, prompts)
    torch.cuda.empty_cache()
    paths["train_llm"] = run_train_llm(device, args.seed)
    torch.cuda.empty_cache()
    paths["entry"] = run_entry(device, args.seed)
    log("entry", "WebVid data and mp4 reading and writing are not driven "
        "here: they need OpenCV, which this machine may lack; the CPU "
        "tests (tests/test_torch_video_data.py) cover them")
    paths["train_hires"] = run_train_hires(device, args.seed)
    torch.cuda.empty_cache()
    paths["multi"] = run_multi(args.seed, prompts[-1])
    paths["decode"] = run_decode(device, args.seed, prompts[-1])
    torch.cuda.empty_cache()
    paths["tools"] = run_tools(device, args.seed)
    log("run", f"wall {time.perf_counter() - t_run:.1f} s from phase 3 on "
        f"(the build {t_run - t0:.1f} s before it)")

    # launches: the main paths' runs together, and each on its own
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
