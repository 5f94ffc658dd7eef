"""Checkpoint converter: a reference torch or safetensors checkpoint (HF,
PL or DeepSpeed dialect) -> the port's parameter file.

Counterpart of open_pandora_tpu/tools/convert_ckpt.py (reference
tools/ckpt2bin.py, pt2bin.py). The file is read by
core.checkpoint.load_torch_flat, its wrappers and renamed keys undone by
core.convert.normalize_state_dict, and checked against the family's model
built on the meta device at PandoraConfig(): a key the model holds that
the file lacks raises KeyError (eval/inference.load_checkpoint's rule),
a shape that differs ValueError; the keys the model does not use are
reported. Unless --dry-run, the model's tensors are written to
--dst/params.pt (core.checkpoint.save_params), a directory `--ckpt`
loads: the CLI, the server and the runners restore it over their model
(world_model), eval/inference.py reads it as a checkpoint
(dynamicrafter).

Usage:
  python -m open_pandora_tpu_torch.tools.convert_ckpt --src PATH --dst DIR \\
      [--family world_model|dynamicrafter] [--dry-run]
"""

from __future__ import annotations

import argparse
import sys

import torch

from open_pandora_tpu_torch.core.config import PandoraConfig


def convert(src: str, dst: str, family: str = "world_model",
            dry_run: bool = False, cfg: PandoraConfig = None) -> dict:
    from open_pandora_tpu_torch.core.checkpoint import (load_torch_flat,
                                                        save_params)
    from open_pandora_tpu_torch.core.convert import normalize_state_dict
    from open_pandora_tpu_torch.eval.inference import missing_keys
    from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter
    from open_pandora_tpu_torch.models.world_model import WorldModel

    cfg = cfg or PandoraConfig()
    flat = load_torch_flat(src)
    print(f"[convert] loaded {len(flat)} torch tensors from {src}")
    sd = normalize_state_dict(flat)
    with torch.device("meta"):
        model = (WorldModel if family == "world_model"
                 else DynamiCrafter)(cfg)
    wanted = model.state_dict()
    missing = missing_keys(wanted, sd)
    if missing:
        raise KeyError(f"{src}: {len(missing)} keys missing, e.g. "
                       f"{missing[:3]}")
    params = {k: sd[k] for k in wanted if k in sd}
    bad = [k for k, v in params.items() if v.shape != wanted[k].shape]
    if bad:
        raise ValueError(f"{src}: {len(bad)} shapes differ, e.g. {bad[0]} "
                         f"{tuple(params[bad[0]].shape)} vs "
                         f"{tuple(wanted[bad[0]].shape)}")
    unused = sorted(set(sd) - set(wanted))
    n = sum(v.numel() for v in params.values())
    print(f"[convert] {len(params)} leaves, {n/1e9:.3f}B params")
    if unused:
        print(f"[convert] {len(unused)} keys unused by the model, e.g. "
              f"{unused[:3]}")
    if not dry_run:
        save_params(dst, params)
        print(f"[convert] wrote {dst}")
    return {"tensors": len(flat), "leaves": len(params), "params": n,
            "unused": unused}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("convert-ckpt")
    p.add_argument("--src", required=True,
                   help="torch .bin/.pt/.ckpt/.safetensors file or HF dir")
    p.add_argument("--dst", required=True, help="output directory")
    p.add_argument("--family", default="world_model",
                   choices=["world_model", "dynamicrafter"])
    p.add_argument("--dry-run", action="store_true",
                   help="convert + report leaf count, no write")
    args = p.parse_args(argv)
    convert(args.src, args.dst, args.family, args.dry_run)
    return 0


if __name__ == "__main__":
    sys.exit(main())
