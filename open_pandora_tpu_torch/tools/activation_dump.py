"""Per-module activation dumps: the parity diff tool.

Counterpart of open_pandora_tpu/tools/activation_dump.py. `capture` runs a
module with a forward hook on every named submodule and keeps each one's
last tensor output (fp32 NumPy) under its module path, plus the module's
own output under `__output__`; `save_npz` writes a dump, `diff_npz`
compares two, module by module in name order, so the first module that
diverges shows (a card's dump against a CPU dump of the same weights and
inputs, or one route against another).

Usage (library):
    from open_pandora_tpu_torch.tools.activation_dump import capture
    acts = capture(unet, x, t, ctx)            # {path: array}

CLI (one fp32 UNet forward on synthetic inputs, random weights):
    python -m open_pandora_tpu_torch.tools.activation_dump --out acts.npz \\
        [--height 320 --width 512] [--tiny] [--seed 0] [--device cuda]
    python -m open_pandora_tpu_torch.tools.activation_dump --out - \\
        --diff A.npz B.npz
`--tiny` is the UNet of eval/inference.debug_config (64 wide, 4 frames,
8x8 latents).
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch


def capture(model: torch.nn.Module, *args, **kwargs) -> Dict[str, np.ndarray]:
    """{module path: its last tensor output} and `__output__`, fp32 NumPy,
    of one `model(*args, **kwargs)` under no_grad."""
    acts: Dict[str, np.ndarray] = {}

    def hook(name):
        def fn(_mod, _inp, out):
            if isinstance(out, torch.Tensor):
                acts[name] = out.detach().float().cpu().numpy()
        return fn

    handles = [m.register_forward_hook(hook(name))
               for name, m in model.named_modules() if name]
    try:
        with torch.no_grad():
            out = model(*args, **kwargs)
    finally:
        for h in handles:
            h.remove()
    acts["__output__"] = out.detach().float().cpu().numpy()
    return acts


def save_npz(path: str, acts: Dict[str, np.ndarray]) -> str:
    np.savez_compressed(path, **acts)
    return path


def diff_npz(a_path: str, b_path: str, top: int = 20):
    """Compare two dumps; print the largest relative divergences in
    topological (name) order so the FIRST bad module is visible."""
    a = np.load(a_path)
    b = np.load(b_path)
    rows = []
    for k in sorted(set(a.files) & set(b.files)):
        x, y = a[k], b[k]           # each array decompressed once
        if x.shape != y.shape:
            rows.append((k, float("inf"), f"shape {x.shape} vs {y.shape}"))
            continue
        denom = max(float(np.abs(y).max()), 1e-8)
        rel = float(np.abs(x - y).max()) / denom
        rows.append((k, rel, ""))
    for k, rel, note in rows[:top] if top else rows:
        print(f"{rel:12.3e}  {k} {note}")
    missing = set(a.files) ^ set(b.files)
    if missing:
        print(f"[diff] {len(missing)} keys only on one side")
    return rows


def unet_inputs(ucfg, *, h: int, w: int, device, seed: int = 0):
    """(x, t, ctx) of one UNet forward, batch 1, from `seed` on the CPU
    (the same values on every device)."""
    g = torch.Generator().manual_seed(seed)
    t = ucfg.temporal_length
    ctx_len = ucfg.text_context_len + t * ucfg.img_tokens_per_frame
    x = torch.randn((1, t, h, w, ucfg.in_channels), generator=g)
    ctx = torch.randn((1, ctx_len, ucfg.context_dim), generator=g)
    return (x.to(device), torch.tensor([500], device=device),
            ctx.to(device))


def build_unet(ucfg, device, seed: int = 0) -> torch.nn.Module:
    """An fp32 UNet with random weights drawn on the CPU from `seed` (the
    same weights on every device)."""
    from open_pandora_tpu_torch.core.init import init_random_
    from open_pandora_tpu_torch.models.unet3d import UNetModel

    unet = UNetModel(ucfg).eval()
    init_random_(unet, torch.Generator().manual_seed(seed))
    return unet.to(device)


def dump_unet(ucfg, device, *, h: int, w: int, seed: int = 0
              ) -> Dict[str, np.ndarray]:
    """The activations of one fp32 UNet forward on synthetic inputs."""
    unet = build_unet(ucfg, device, seed)
    return capture(unet, *unet_inputs(ucfg, h=h, w=w, device=device,
                                      seed=seed + 1))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("activation-dump")
    p.add_argument("--out", required=True)
    p.add_argument("--diff", nargs=2, metavar=("A", "B"),
                   help="instead of dumping: diff two npz dumps")
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    if args.diff:
        diff_npz(*args.diff)
        return 0
    if args.tiny:
        from open_pandora_tpu_torch.eval.inference import debug_config
        ucfg, h, w = debug_config().unet, 8, 8
    else:
        from open_pandora_tpu_torch.core.config import UNet3DConfig
        ucfg, h, w = UNet3DConfig(), args.height // 8, args.width // 8
    acts = dump_unet(ucfg, torch.device(args.device), h=h, w=w,
                     seed=args.seed)
    save_npz(args.out, acts)
    print(f"[dump] {len(acts)} activations -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
