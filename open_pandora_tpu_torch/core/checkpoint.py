"""Training checkpoints and the run workspace.

Counterpart of save_params / restore_params in
open_pandora_tpu/core/checkpoint.py and of init_workspace /
find_latest_checkpoint in open_pandora_tpu/train/trainer.py:32-63. The
trainable parameters are saved with torch.save into `step_<n>`
directories (the JAX package uses Orbax; neither Orbax nor safetensors is
on the card's machine). The workspace is {logdir}/{name}/{checkpoints,
configs,loginfo} (reference utils_train.py:9-26).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import torch

PARAMS_FILE = "params.pt"


def init_workspace(logdir: str, name: str, cfg) -> Dict[str, str]:
    """Create the run's directories and write its config as JSON."""
    root = os.path.join(logdir, name)
    dirs = {k: os.path.join(root, k)
            for k in ("checkpoints", "configs", "loginfo")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    with open(os.path.join(dirs["configs"], "config.json"), "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    dirs["root"] = root
    return dirs


def save_params(ckpt_dir: str, params: Dict[str, torch.Tensor],
                step: int) -> str:
    """Write `params` (name -> tensor) to {ckpt_dir}/step_{step}/params.pt,
    through a temporary file renamed into place."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, PARAMS_FILE)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               out + ".tmp")
    os.replace(out + ".tmp", out)
    return path


@torch.no_grad()
def restore_params(path: str, like: Dict[str, torch.Tensor]) -> None:
    """Copy the parameters saved under `path` into `like` (name -> tensor,
    in place); the two key sets must be equal."""
    saved = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                       weights_only=True)
    if saved.keys() != like.keys():
        missing = sorted(like.keys() - saved.keys())
        extra = sorted(saved.keys() - like.keys())
        raise KeyError(f"{path}: missing {missing[:3]}, unexpected "
                       f"{extra[:3]}")
    for k, t in like.items():
        t.copy_(saved[k])


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The `step_<n>` directory with the largest n, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[5:]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")
