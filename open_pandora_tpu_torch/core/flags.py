"""The registry of the PANDORA_* runtime flags the port honours.

Counterpart of open_pandora_tpu/core/flags.py, with the same API (`flag`,
`set_flag`, `clear_flag`, `overridden`, `snapshot`, `table`) and the same
parsing, but only the flags that select a route or an asset the port has:
the UNet's opt-in 3x3 conv routes and their census, the switches of the
default bf16 eval route's kernels, the training graph's nested
recomputation, and the CLIP merges file. Whether a
kernel or its plain version serves a call is chosen by the tensor's device
alone.

  - library code asks `flags.flag("PANDORA_X")`, never `os.environ`;
  - a programmatic override wins over the environment
    (`flags.set_flag(...)`, the `flags.overridden(...)` context manager);
  - `flags.snapshot()` returns the effective non-default set, printed
    beside every reading taken under a flag.

Environment values parse as: bools -- "", "0", "false", "off", "no" are
False, anything else True; strs -- literal. The port runs eagerly, so a flag
is read at each call: changing one takes effect on the next forward.
"""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator


@dataclass(frozen=True)
class FlagSpec:
    name: str
    kind: str          # "bool" | "int" | "str"
    default: Any
    doc: str


_SPECS = [
    # -- the UNet's 3x3 conv routes (opt-in, as in the JAX package)
    FlagSpec("PANDORA_ENABLE_PCONV", "bool", False,
             "Opt-in: route eligible eval 3x3 convs to the direct conv "
             "kernel v1 (ops/conv2d.py conv3x3_nhwc)."),
    FlagSpec("PANDORA_ENABLE_PCONV2", "bool", False,
             "Opt-in: route eligible eval GN+SiLU+conv+bias+residual sites "
             "to the fused conv kernel v2 (ops/conv2d.py conv3x3_fused)."),
    FlagSpec("PANDORA_DISABLE_PCONV", "bool", False,
             "Hard-off for both conv kernels regardless of the enable "
             "flags."),
    FlagSpec("PANDORA_PCONV_ONLY", "str", "",
             "Comma list of HxWxCIxCO shapes: ONLY those conv sites route "
             "to the conv kernels (bisection tool)."),
    FlagSpec("PANDORA_CONV_CENSUS", "bool", False,
             "Record every 3x3 conv site's (h, w, c, co) into "
             "ops.conv2d.CENSUS."),
    FlagSpec("PANDORA_SPATIAL_DOT", "bool", False,
             "Route the 3x3 convs that take neither kernel through nine "
             "shifted matmuls (ops/conv2d.py conv3x3_ninedot) instead of "
             "the library convolution."),
    # -- the default bf16 eval route's kernels (on unless switched off)
    FlagSpec("PANDORA_DISABLE_FUSED", "bool", False,
             "Master off-switch of the fused route: the packed, dual "
             "cross-attention and fused temporal kernels and the "
             "GroupNorm+SiLU kernel; their sites take the unfused route "
             "(models/unet3d.py, ops/fused_norms.py)."),
    FlagSpec("PANDORA_DISABLE_FUSED_GN", "bool", False,
             "Disable only the GroupNorm+SiLU kernel "
             "(ops/fused_norms.py)."),
    FlagSpec("PANDORA_DISABLE_PACKED", "bool", False,
             "Route the packed-layout attention sites (attn1, and the dual "
             "attn2 the packed gate admits) to the head-split route "
             "(ops/packed_attention.py packed_attention_eligible)."),
    FlagSpec("PANDORA_DISABLE_DUALCA", "bool", False,
             "Disable the dual cross-attention kernel; the text and image "
             "streams take two attentions (ops/dual_cross_attention.py)."),
    FlagSpec("PANDORA_DISABLE_TNATIVE", "bool", False,
             "Keep the temporal transformers off the native (b, t, h*w, c) "
             "stream: transpose to (b*h*w, t, c) (models/unet3d.py)."),
    # -- training-graph switches
    FlagSpec("PANDORA_FINE_REMAT", "bool", False,
             "In training, recompute each transformer block's attn1, attn2 "
             "and feed-forward (each chunk of it) on its own in the "
             "backward, inside the block-level checkpoint (576x1024 memory "
             "relief; changes no value; models/unet3d.py)."),
    # -- pipeline assets
    FlagSpec("PANDORA_CLIP_BPE", "str", "",
             "Path to a CLIP BPE merges file (pipeline/tokenizers.py)."),
]

REGISTRY: Dict[str, FlagSpec] = {s.name: s for s in _SPECS}

_overrides: Dict[str, Any] = {}
_MISSING = object()


def _parse(spec: FlagSpec, raw: str) -> Any:
    if spec.kind == "bool":
        return raw.strip().lower() not in ("", "0", "false", "off", "no")
    if spec.kind == "int":
        try:
            return int(raw)
        except ValueError:
            return spec.default
    return raw


def flag(name: str) -> Any:
    """Effective value: programmatic override > environment > default."""
    spec = REGISTRY[name]
    if name in _overrides:
        return _overrides[name]
    raw = os.environ.get(name)
    if raw is None:
        return spec.default
    return _parse(spec, raw)


def set_flag(name: str, value: Any) -> None:
    if name not in REGISTRY:
        raise KeyError(f"undeclared flag {name!r} -- add it to "
                       "core/flags.py REGISTRY")
    _overrides[name] = value


def clear_flag(name: str) -> None:
    _overrides.pop(name, None)


@contextlib.contextmanager
def overridden(**kv: Any) -> Iterator[None]:
    """Scoped overrides (keys without the PANDORA_ prefix are accepted)."""
    full = {k if k.startswith("PANDORA_") else "PANDORA_" + k: v
            for k, v in kv.items()}
    saved = {k: _overrides.get(k, _MISSING) for k in full}
    try:
        for k, v in full.items():
            set_flag(k, v)
        yield
    finally:
        for k, v in saved.items():
            if v is _MISSING:
                _overrides.pop(k, None)
            else:
                _overrides[k] = v


def snapshot(only_non_default: bool = True) -> Dict[str, Any]:
    """The effective flag set (printed beside readings taken under it)."""
    out = {}
    for name, spec in REGISTRY.items():
        v = flag(name)
        if only_non_default and v == spec.default:
            continue
        out[name] = v
    return out


def table() -> str:
    """Markdown table of every flag (README documentation)."""
    rows = ["| flag | type | default | effect |", "|---|---|---|---|"]
    for s in _SPECS:
        rows.append(f"| `{s.name}` | {s.kind} | `{s.default!r}` | {s.doc} |")
    return "\n".join(rows)


if __name__ == "__main__":  # pragma: no cover
    print(table())
