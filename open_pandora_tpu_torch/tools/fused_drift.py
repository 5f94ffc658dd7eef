"""The bf16 drift of the fused route against the unfused route over one
seeded clip.

Counterpart of open_pandora_tpu/tools/fused_drift.py: the same seeded DDIM
synthesis (random bf16 weights, the same inputs and noise: text context
N(0, 1) * 0.2, a uniform image, uniform frames in [-1, 1], guidance 7.5,
eta 1, fs 15; x_T and the DDIM noise drawn once from seed 42) and its
decode in 8-frame chunks, once on the default (fused) route and once
under PANDORA_DISABLE_FUSED=1; printed as JSON:
`ddim_steps`, the latents' `shape`, and for the latents `z` and the
decoded `frames` the max_abs, mean_abs and rel_mean of the difference.

The port reads its flags at each call (core/flags.py), so both runs share
one process, one model and one set of inputs (core.flags.overridden). The
unfused route still runs kernels on a card: the flash and small
attention kernels (rows 1 and 2) stay on it, so the drift is the fused
route against the unfused route, not kernels against none.

Usage: python -m open_pandora_tpu_torch.tools.fused_drift
       [--ddim-steps 10] [--height 320 --width 512] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from open_pandora_tpu_torch.core import flags
from open_pandora_tpu_torch.core.config import PandoraConfig


def _clip(model, inputs, draws, ddim_steps: int):
    dt = model.dtype
    with torch.no_grad():
        z = model.image_guided_synthesis(
            **{k: v.to(dt) for k, v in inputs.items()},
            ddim_steps=ddim_steps, guidance_scale=7.5, eta=1.0, fs=15,
            x_T=draws[0].to(dt), noise=[n.to(dt) for n in draws[1]])
        chunk = 8 if z.shape[1] % 8 == 0 else 1
        frames = model.decode(z, frame_chunk=chunk)
    return z.float().cpu().numpy(), frames.float().cpu().numpy()


def _diff(a, b) -> dict:
    """max_abs, mean_abs and rel_mean (mean_abs over b's mean |value|) of
    a - b, for the latents `z` and the `frames`."""
    rep = {}
    for i, key in enumerate(("z", "frames")):
        d = np.abs(a[i] - b[i])
        scale = float(np.abs(b[i]).mean())
        rep[key] = {"max_abs": float(d.max()), "mean_abs": float(d.mean()),
                    "rel_mean": float(d.mean() / max(scale, 1e-12))}
    return rep


def fused_drift(cfg: PandoraConfig, device, *, ddim_steps: int = 10,
                height: int = 320, width: int = 512,
                dtype=torch.bfloat16, fp32_reference: bool = False) -> dict:
    """The drift report. x_T and the per-step DDIM noise are drawn once, in
    `dtype`, and given to every run. With `fp32_reference`, the model is
    then upcast to fp32 (the same weights) and run a third time on the
    same inputs and draws, upcast: the unfused route, the only one at fp32;
    `fp32_reference` holds each bf16 route's drift from that run, which
    tells a route that computes something else from bf16 rounding."""
    from open_pandora_tpu_torch.eval.inference import build_model

    device = torch.device(device)
    model = build_model(cfg, device=device, dtype=dtype,
                        generator=torch.Generator(device=device)
                        .manual_seed(0))
    u = cfg.unet
    gen = torch.Generator(device=device).manual_seed(11)
    inputs = {
        "text_context": (torch.randn(
            (1, u.text_context_len, u.context_dim), generator=gen,
            device=device) * 0.2).to(dtype),
        "cond_images": torch.rand((1, height, width, 3), generator=gen,
                                  device=device).to(dtype),
        "cond_frames": (torch.rand((1, 1, height, width, 3), generator=gen,
                                   device=device) * 2 - 1).to(dtype),
    }
    f = 2 ** (len(cfg.vae.channel_mult) - 1)
    shape = (1, u.temporal_length, height // f, width // f,
             cfg.vae.z_channels)
    gen = torch.Generator(device=device).manual_seed(42)
    draws = [torch.randn(shape, generator=gen, device=device, dtype=dtype)
             for _ in range(ddim_steps + 1)]
    draws = (draws[0], draws[1:])
    outs = {"fused": _clip(model, inputs, draws, ddim_steps)}
    with flags.overridden(DISABLE_FUSED=True):
        outs["unfused"] = _clip(model, inputs, draws, ddim_steps)
    if fp32_reference:
        model.float()
        outs["fp32"] = _clip(model, inputs, draws, ddim_steps)
    del model
    rep = {"ddim_steps": ddim_steps, "shape": list(outs["fused"][0].shape),
           **_diff(outs["fused"], outs["unfused"])}
    if fp32_reference:
        rep["fp32_reference"] = {route: _diff(outs[route], outs["fp32"])
                                 for route in ("fused", "unfused")}
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("fused-drift")
    ap.add_argument("--ddim-steps", type=int, default=10)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(json.dumps(fused_drift(PandoraConfig(), args.device,
                                 ddim_steps=args.ddim_steps,
                                 height=args.height, width=args.width)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
