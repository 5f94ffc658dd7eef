"""Configuration of the DynamiCrafter slices (image-to-video and its
finetune stage), with YAML loading and dotted overrides.

Counterpart of open_pandora_tpu/core/config.py for the sub-configs this
package uses, with the same fields and defaults: the shipped Open-Pandora
checkpoint (DynamiCrafter inference_512_v1.0.yaml) and the training stages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class VAEConfig:
    """SD 2D autoencoder (lvdm/models/autoencoder.py)."""

    in_channels: int = 3
    out_channels: int = 3
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    embed_dim: int = 4
    double_z: bool = True
    scale_factor: float = 0.18215


@dataclass(frozen=True)
class UNet3DConfig:
    """UNet3D (lvdm/modules/networks/openaimodel3d.py)."""

    in_channels: int = 8           # 4 latent + 4 concat-cond (hybrid key)
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    temporal_length: int = 16
    temporal_conv: bool = True
    temporal_attention: bool = True
    temporal_selfatt_only: bool = True
    use_relative_position: bool = False
    use_causal_attention: bool = False
    addition_attention: bool = True    # init temporal attn after input conv
    image_cross_attention: bool = True  # dual-stream text+image cross attn
    image_cross_attention_scale_learnable: bool = False
    fs_condition: bool = True
    default_fs: int = 24
    dropout: float = 0.1
    use_checkpoint: bool = True
    # context layout: `text_context_len` text tokens, then
    # `temporal_length` * `img_tokens_per_frame` image tokens
    text_context_len: int = 77
    img_tokens_per_frame: int = 16


@dataclass(frozen=True)
class CLIPTextConfig:
    """OpenCLIP ViT-H-14 text tower, penultimate layer."""

    vocab_size: int = 49408
    width: int = 1024
    layers: int = 24
    heads: int = 16
    context_length: int = 77
    penultimate: bool = True


@dataclass(frozen=True)
class CLIPVisionConfig:
    """OpenCLIP ViT-H-14 visual tower returning all 257 tokens."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16


@dataclass(frozen=True)
class ResamplerConfig:
    """Perceiver resampler (image_proj_model)."""

    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4
    video_length: int = 16


@dataclass(frozen=True)
class DiffusionConfig:
    """DDPM schedule and parameterization; schedules are kept in fp32."""

    timesteps: int = 1000
    linear_start: float = 0.00085
    linear_end: float = 0.012
    parameterization: str = "v"
    rescale_betas_zero_snr: bool = True
    use_dynamic_rescale: bool = True
    base_scale: float = 0.7
    scale_factor: float = 0.18215
    uncond_type: str = "empty_seq"
    fps_condition_type: str = "fps"
    perframe_ae: bool = True
    loss_type: str = "l2"
    logvar_init: float = 0.0
    l_simple_weight: float = 1.0
    original_elbo_weight: float = 0.0


@dataclass(frozen=True)
class SamplerConfig:
    """DDIM sampling defaults."""

    steps: int = 50
    eta: float = 1.0
    guidance_scale: float = 4.0
    guidance_rescale: float = 0.0
    timestep_spacing: str = "uniform_trailing"
    cfg_img: Optional[float] = None
    batched_cfg: bool = True
    fs: int = 15


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh, as the shipped config files set it. The port runs on one
    device: a mesh of more waits for the multi-device slice."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1    # -1 = all devices
    model_parallel: int = 1
    shard_opt_state: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training stages (reference: config/config.yaml, config_align.yaml,
    config_finetune.yaml + model.py:951-972)."""

    stage: str = "finetune"              # "alignment" | "finetune"
    learning_rate: float = 5e-5
    min_lr: float = 1e-6
    lr_schedule: str = "constant"        # alignment uses cosine (model.py:967)
    max_steps: int = 200_000
    batch_size_per_device: int = 1
    grad_clip_norm: float = 0.5
    weight_decay: float = 0.0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    uncond_prob: float = 0.1             # CFG dropout (model.py:860-868)
    video_length: int = 16
    cond_frames: int = 4
    height: int = 320
    width: int = 512
    frame_stride: int = 6
    fixed_fps: Optional[int] = None
    ckpt_every: int = 10_000
    log_every: int = 100
    seed: int = 23
    # EMA shadow params (reference LitEma, lvdm/ema.py; off in every
    # shipped config)
    use_ema: bool = False
    ema_decay: float = 0.9999
    # "adamw" (reference model.py:951-965); the JAX package's "adamw8bit"
    # waits for a later slice
    optimizer: str = "adamw"


@dataclass(frozen=True)
class PandoraConfig:
    """The sub-configs of the DynamiCrafter slices."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    clip_text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    clip_vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    resampler: ResamplerConfig = field(default_factory=ResamplerConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    dtype_policy: str = "bf16"   # "bf16" | "fp32" (golden parity mode)


def param_dtype(policy: str):
    """The torch dtype of the parameters under a dtype policy
    (open_pandora_tpu/core/dtypes.py `policy_from_name`)."""
    import torch

    if policy in ("bf16", "bfloat16", "mixed"):
        return torch.bfloat16
    if policy in ("fp32", "float32", "golden"):
        return torch.float32
    raise ValueError(f"unknown dtype policy {policy!r}")


# ---------------------------------------------------------------------------
# YAML loading + dotted overrides
# ---------------------------------------------------------------------------


def _set_dotted(cfg, dotted: str, value: Any):
    """Return a new config with `a.b.c=value` applied (frozen dataclasses)."""
    parts = dotted.split(".")

    def rec(node, idx):
        name = parts[idx]
        if not dataclasses.is_dataclass(node) or not hasattr(node, name):
            raise KeyError(f"unknown config path {dotted!r} (at {name!r})")
        if idx == len(parts) - 1:
            new_val = _coerce(value, getattr(node, name))
            return dataclasses.replace(node, **{name: new_val})
        child = rec(getattr(node, name), idx + 1)
        return dataclasses.replace(node, **{name: child})

    return rec(cfg, 0)


def _coerce(value: Any, like: Any):
    if isinstance(value, str):
        if isinstance(like, bool):
            return value.lower() in ("1", "true", "yes", "on")
        if isinstance(like, int):
            return int(value)
        if isinstance(like, float):
            return float(value)
        if isinstance(like, tuple):
            return (tuple(type(like[0])(v) for v in value.split(","))
                    if like else tuple(value.split(",")))
    if isinstance(value, list):
        return tuple(value)
    return value


def _deep_merge(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = v


def _merge_into_dataclass(node, data: dict):
    kwargs = {}
    for key, value in data.items():
        if not hasattr(node, key):
            raise KeyError(f"unknown config key {key!r} for "
                           f"{type(node).__name__}")
        current = getattr(node, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            kwargs[key] = _merge_into_dataclass(current, value)
        else:
            kwargs[key] = _coerce(value, current)
    return dataclasses.replace(node, **kwargs)


def load_config(yaml_paths: Sequence[str] = (),
                overrides: Sequence[str] = (),
                base: Optional[PandoraConfig] = None) -> PandoraConfig:
    """Build a PandoraConfig from defaults (or `base`) + YAML files (merged
    left to right) + `key.path=value` overrides, as `load_config` in the
    JAX package. PyYAML is imported only when a file is given."""
    merged: dict = {}
    for path in yaml_paths:
        try:
            import yaml
        except ImportError as e:
            raise RuntimeError(f"reading {path} needs PyYAML, which is not "
                               "installed; pass --set overrides instead"
                               ) from e
        with open(path) as f:
            _deep_merge(merged, yaml.safe_load(f) or {})
    cfg = base if base is not None else PandoraConfig()
    if merged:
        cfg = _merge_into_dataclass(cfg, merged)
    for ov in overrides:
        key, _, val = ov.partition("=")
        cfg = _set_dotted(cfg, key.strip(), val.strip())
    return cfg
