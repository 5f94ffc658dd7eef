"""Name -> constructor registry: the reference's `instantiate_from_config`
target grammar resolved to the port's classes and functions.

Counterpart of open_pandora_tpu/core/registry.py. The reference builds its
diffusion graph from yaml `{target: dotted.torch.path, params: {...}}`
nodes (DynamiCrafter/utils/utils.py:27-42; configs/inference_512_v1.0.yaml);
the port keeps a typed config tree (core/config.py) but resolves every
dotted target the reference tree can name:

    resolve_target("lvdm.modules.networks.openaimodel3d.UNetModel")
        -> open_pandora_tpu_torch.models.unet3d.UNetModel

`build_from_target` instantiates, forwarding params; the port's modules
take their typed config through `cfg=`.
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict

_P = "open_pandora_tpu_torch."

# reference dotted target -> "module_path:attr" of the port, imported when
# resolved
_TARGETS: Dict[str, str] = {
    # composite / diffusion stack
    "lvdm.models.ddpm3d.LatentDiffusion":
        _P + "models.dynamicrafter:DynamiCrafter",
    "lvdm.models.ddpm3d.LatentVisualDiffusion":
        _P + "models.dynamicrafter:DynamiCrafter",
    "lvdm.modules.networks.openaimodel3d.UNetModel":
        _P + "models.unet3d:UNetModel",
    "lvdm.models.autoencoder.AutoencoderKL":
        _P + "models.vae:AutoencoderKL",
    "lvdm.modules.encoders.resampler.Resampler":
        _P + "models.encoders:Resampler",
    # conditioning encoders (shipped pair)
    "lvdm.modules.encoders.condition.FrozenOpenCLIPEmbedder":
        _P + "models.encoders:CLIPTextEncoder",
    "lvdm.modules.encoders.condition.FrozenOpenCLIPImageEmbedderV2":
        _P + "models.encoders:CLIPVisionEncoder",
    # conditioning encoders (alternative set, encoders_extra)
    "lvdm.modules.encoders.condition.FrozenT5Embedder":
        _P + "models.encoders_extra:T5Encoder",
    "lvdm.modules.encoders.condition.FrozenCLIPEmbedder":
        _P + "models.encoders_extra:HFCLIPTextEncoder",
    "lvdm.modules.encoders.condition.ClassEmbedder":
        _P + "models.encoders_extra:ClassEmbedder",
    "lvdm.modules.encoders.condition.ClipImageEmbedder":
        _P + "models.encoders_extra:PooledCLIPImageEncoder",
    "lvdm.modules.encoders.condition.FrozenCLIPT5Encoder":
        _P + "models.encoders_extra:CLIPT5Pair",
    "lvdm.modules.encoders.condition.IdentityEncoder":
        _P + "core.registry:_identity",
    "torch.nn.Identity":
        _P + "core.registry:_identity",
    # samplers
    "lvdm.models.samplers.ddim.DDIMSampler":
        _P + "diffusion.ddim:ddim_sample",
}


def _identity(x: Any = None, **_: Any) -> Any:
    return x


def resolve_target(target: str) -> Callable:
    """Reference dotted target string -> the port's class or function."""
    try:
        spec = _TARGETS[target]
    except KeyError:
        raise KeyError(
            f"unknown reference target {target!r}; known: "
            f"{sorted(_TARGETS)}") from None
    mod, attr = spec.split(":")
    return getattr(importlib.import_module(mod), attr)


def build_from_target(node: Dict[str, Any], **overrides: Any) -> Any:
    """Instantiate a `{target: ..., params: {...}}` yaml node.

    `overrides` win over the node's params. Modules built from a typed
    config (UNetModel(cfg), CLIPTextEncoder(cfg), ...) take it as a `cfg=`
    override; raw reference params are not translated to it (the field
    names differ, see core/config.py)."""
    ctor = resolve_target(node["target"])
    params = dict(node.get("params", {}))
    params.update(overrides)
    return ctor(**params) if params else ctor()
