"""Checkpoint reading, training checkpoints and the run workspace.

Counterpart of load_torch_flat / save_params / restore_params in
open_pandora_tpu/core/checkpoint.py and of init_workspace /
find_latest_checkpoint in open_pandora_tpu/train/trainer.py:32-63. The
trainable parameters are saved with torch.save into `step_<n>`
directories (the JAX package uses Orbax). Reference checkpoints are read
by `load_torch_flat`: torch files and `.safetensors` files, one file or a
directory of HF shards; the `.safetensors` reader is this module's own,
since the card's machine has no safetensors package. The workspace is
{logdir}/{name}/{checkpoints,configs,loginfo} (reference
utils_train.py:9-26).
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import struct
import sys
from typing import Dict, Optional

import torch

PARAMS_FILE = "params.pt"
CKPT_SUFFIXES = (".bin", ".safetensors", ".pt", ".ckpt")

# safetensors dtype names -> torch dtypes; any other name (the float8s,
# complex) is refused
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "BOOL": torch.bool,
    "I8": torch.int8, "U8": torch.uint8, "I16": torch.int16,
    "U16": torch.uint16, "I32": torch.int32, "U32": torch.uint32,
    "I64": torch.int64, "U64": torch.uint64,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file -> {key: CPU tensor}: an 8-byte little-endian
    header length, a JSON header of each tensor's dtype, shape and byte
    offsets (from the end of the header; `__metadata__` skipped), then the
    raw little-endian data. Each tensor is read into its own buffer."""
    if sys.byteorder != "little":
        raise RuntimeError("read_safetensors reads little-endian data on a "
                           "little-endian host only")
    out: Dict[str, torch.Tensor] = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for key, spec in header.items():
            if key == "__metadata__":
                continue
            dtype = SAFETENSORS_DTYPES.get(spec["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {key} has dtype {spec['dtype']}; "
                                 f"read are {sorted(SAFETENSORS_DTYPES)}")
            start, end = spec["data_offsets"]
            shape = tuple(spec["shape"])
            numel = 1
            for d in shape:
                numel *= d
            if end - start != numel * dtype.itemsize:
                raise ValueError(f"{path}: {key} holds {end - start} bytes "
                                 f"for {shape} {spec['dtype']}")
            buf = bytearray(end - start)
            f.seek(base + start)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{path}: {key} runs past the file's end")
            t = (torch.frombuffer(buf, dtype=dtype) if buf
                 else torch.empty(0, dtype=dtype))
            out[key] = t.reshape(shape)
    return out


def load_torch_flat(path: str) -> Dict[str, torch.Tensor]:
    """A reference checkpoint -> {key: tensor}: one file, or the sorted
    `.bin` / `.pt` / `.ckpt` / `.safetensors` files of a directory (HF
    shards). Torch files load with `weights_only=True`, unwrapped from a
    `state_dict` or `module` dict (PL, DeepSpeed); keys keep their
    prefixes (core.convert.normalize_state_dict strips them). A PL file
    whose other entries (hyper-parameters) hold classes outside torch's
    safe list is refused by that load: save its `state_dict` on its own.
    In a directory, a torch file that is not a dict of weights (HF
    Trainer's pickled `training_args.bin`) is skipped, as the JAX loader
    skips a non-dict; it is named in the error only when the directory
    holds no weights at all. The JAX package loads with
    weights_only=False and returns NumPy."""
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path))
                 if f.endswith(CKPT_SUFFIXES)]
    else:
        files = [path]
    flat: Dict[str, torch.Tensor] = {}
    skipped = []
    for f in files:
        if f.endswith(".safetensors"):
            flat.update(read_safetensors(f))
            continue
        try:
            raw = torch.load(f, map_location="cpu", weights_only=True)
        except pickle.UnpicklingError:
            if f == path:
                raise
            skipped.append(f)
            continue
        if not isinstance(raw, dict):
            skipped.append(f)
            continue
        for wrapper in ("state_dict", "module"):
            if isinstance(raw.get(wrapper), dict):
                raw = raw[wrapper]
                break
        flat.update({k: v if isinstance(v, torch.Tensor)
                     else torch.as_tensor(v) for k, v in raw.items()
                     if isinstance(v, (torch.Tensor, int, float))})
    if skipped and not flat:
        raise ValueError(f"{path}: no weights; these files hold no dict of "
                         f"tensors: {skipped}")
    return flat


def init_workspace(logdir: str, name: str, cfg,
                   write: bool = True) -> Dict[str, str]:
    """The run's directories; with `write` (the writing rank) create them
    and write the config as JSON."""
    root = os.path.join(logdir, name)
    dirs = {k: os.path.join(root, k)
            for k in ("checkpoints", "configs", "loginfo")}
    if write:
        for d in dirs.values():
            os.makedirs(d, exist_ok=True)
        with open(os.path.join(dirs["configs"], "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2, default=str)
    dirs["root"] = root
    return dirs


def save_params(ckpt_dir: str, params: Dict[str, torch.Tensor],
                step: Optional[int] = None) -> str:
    """Write `params` (name -> tensor) to {ckpt_dir}/step_{step}/params.pt,
    or with no step to {ckpt_dir}/params.pt, through a temporary file
    renamed into place; returns the directory."""
    path = (os.path.join(ckpt_dir, f"step_{step}") if step is not None
            else ckpt_dir)
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, PARAMS_FILE)
    torch.save({k: v.detach().cpu() for k, v in params.items()},
               out + ".tmp")
    os.replace(out + ".tmp", out)
    return path


@torch.no_grad()
def restore_params(path: str, like: Dict[str, torch.Tensor],
                   strict: bool = True) -> None:
    """Copy the parameters saved under `path` into `like` (name -> tensor,
    in place); the two key sets must be equal, or with strict=False the
    saved keys a subset of `like`'s (a run's trainable parameters restored
    into a whole model's state dict)."""
    saved = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu",
                       weights_only=True)
    if (saved.keys() != like.keys() if strict
            else not saved.keys() <= like.keys()):
        missing = sorted(like.keys() - saved.keys())
        extra = sorted(saved.keys() - like.keys())
        raise KeyError(f"{path}: missing {missing[:3]}, unexpected "
                       f"{extra[:3]}")
    for k, v in saved.items():
        like[k].copy_(v)


def find_latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The `step_<n>` directory with the largest n, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d[5:]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and d[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")
