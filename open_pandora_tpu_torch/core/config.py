"""Configuration of the ported slices (image-to-video, its finetune stage
and the LLM conditioning), with YAML loading and dotted overrides.

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
class T5Config:
    """T5 v1.1 encoder (reference condition.py:62-91 FrozenT5Embedder, an
    alternative text conditioner no shipped config uses); the defaults are
    google/t5-v1_1-large's encoder."""

    vocab_size: int = 32128
    d_model: int = 1024
    d_kv: int = 64
    d_ff: int = 2816
    num_layers: int = 24
    num_heads: int = 16
    relative_buckets: int = 32
    relative_max_distance: int = 128
    layer_norm_eps: float = 1e-6


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
class CLIPTowerConfig:
    """CLIP ViT-L/14 vision tower of the LLM: hidden states of layer
    `select_layer`, patch tokens only (256 per 224**2 image)."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    select_layer: int = -2
    # "clip" (shipped) or a name starting "eva_vit_g" (models/eva_tower.py;
    # EVA-ViT-g: width 1408, 39 layers, 16 heads, mlp_ratio 4.3637)
    tower_type: str = "clip"
    mlp_ratio: float = 4.0


@dataclass(frozen=True)
class LLaMAConfig:
    """LLaMA-7B trunk (HF LLaMA dims)."""

    vocab_size: int = 32000
    extra_tokens: int = 3          # <img_s>, <image>, [IMG_P]
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # LoRA adapters on every linear projection except lm_head
    # (ChatUniVi train.py:98-103 defaults r=64 alpha=16). 0 = off.
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @property
    def total_vocab(self) -> int:
        return self.vocab_size + self.extra_tokens


@dataclass(frozen=True)
class ClusterConfig:
    """DPC-KNN token clustering rates."""

    spatial_rates: Tuple[int, ...] = (64, 32, 16)  # 3-stage image clustering
    temporal_rate: float = 1.0 / 16.0              # video event clustering
    k_knn: int = 5


@dataclass(frozen=True)
class QFormerConfig:
    """BLIP-2 Q-Former: hidden 768, 12 layers, cross-attention every 2."""

    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    cross_attention_frequency: int = 2
    num_query_tokens: int = 77
    layer_norm_eps: float = 1e-12


@dataclass(frozen=True)
class ConnectorConfig:
    """The trainable connector between the LLM and the diffusion model."""

    llm_hidden: int = 4096
    image_prefix_length: int = 64   # rows of image_prefix used as prefix embeds
    qformer_proj_dim: int = 768     # 4096 -> 768
    proj_out_dim: int = 1024        # 768 -> 1024 (the UNet's context dim)
    use_image_prefix: bool = True
    # a causal CLIP text transformer over the connector output
    # (models/encoders.CLIPTextEmbeddingEncoder; no shipped config sets it)
    use_diffusion_text_encoder: bool = False


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
    """The (data, model) mesh over the ranks torchrun starts
    (parallel/mesh.py build_mesh): data_parallel -1 takes every rank not in
    the model axis; shard_opt_state turns ZeRO-2 on (the optimizer state
    split over the data axis)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1    # -1 = all devices
    model_parallel: int = 1
    shard_opt_state: bool = True


@dataclass(frozen=True)
class TrainConfig:
    """Training stages (reference: config/config.yaml, config_align.yaml,
    config_finetune.yaml + model.py:951-972)."""

    # "alignment" | "finetune" | "dynamicrafter" | "llm_sft"
    stage: str = "finetune"
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
    # "adamw" (reference model.py:951-965) or "adamw8bit" (blockwise int8
    # moments, train/optim8bit.py)
    optimizer: str = "adamw"


@dataclass(frozen=True)
class PandoraConfig:
    """The sub-configs of the ported slices."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    clip_text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    clip_vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    clip_tower: CLIPTowerConfig = field(default_factory=CLIPTowerConfig)
    resampler: ResamplerConfig = field(default_factory=ResamplerConfig)
    llama: LLaMAConfig = field(default_factory=LLaMAConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)
    qformer: QFormerConfig = field(default_factory=QFormerConfig)
    connector: ConnectorConfig = field(default_factory=ConnectorConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    # global switches
    do_alignment: bool = False   # alignment stage: no diffusion model built
    dtype_policy: str = "bf16"   # "bf16" | "fp32" (golden parity mode)

    @property
    def default_sampling(self) -> Tuple[int, int, int]:
        """(height, width, steps) of a clip unless the caller sets them:
        the model's frame size and its DDIM steps."""
        return self.train.height, self.train.width, self.sampler.steps


# ---------------------------------------------------------------------------
# Stable Video Diffusion (SVD / SVD-XT) image-to-video
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VideoUNetConfig:
    """SVD's VideoUNet (sgm/modules/diffusionmodules/video_model.py), the
    network_config of scripts/sampling/configs/svd_xt.yaml: every ResBlock
    a VideoResBlock (a (3, 1, 1) temporal ResBlock blended by a learned
    alpha), every transformer a SpatialVideoTransformer (a
    VideoTransformerBlock with its own GEGLU `ff_in` after each spatial
    block), the vector conditioning through `label_emb`."""

    in_channels: int = 8           # 4 latent + 4 concat (the image latent)
    out_channels: int = 4
    model_channels: int = 320
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    num_head_channels: int = 64
    transformer_depth: int = 1
    context_dim: int = 1024
    # fps_id, motion_bucket_id and cond_aug, each embedded sinusoidally
    # at a third of the width
    adm_in_channels: int = 768
    num_frames: int = 25


@dataclass(frozen=True)
class CLIPImageEmbedConfig(CLIPVisionConfig):
    """OpenCLIP ViT-H-14 read out as SVD's FrozenOpenCLIPImageEmbedder does:
    ln_post and proj on the class token, one `output_dim` vector an
    image."""

    output_dim: int = 1024


@dataclass(frozen=True)
class EDMSamplerConfig:
    """EulerEDMSampler with EDMDiscretization and LinearPredictionGuider
    (svd_xt.yaml sampler_config; scripts/sampling/simple_video_sample.py
    defaults for version svd_xt)."""

    steps: int = 30
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    min_guidance_scale: float = 1.5
    max_guidance_scale: float = 3.0
    fps_id: int = 6
    motion_bucket_id: int = 127
    cond_aug: float = 0.02
    decoding_t: int = 14


@dataclass(frozen=True)
class SVDConfig:
    """Stable Video Diffusion XT image-to-video: VideoUNet, the SD VAE
    encoder for the concat latent and the temporal VideoDecoder, OpenCLIP
    ViT-H's pooled image embedding, EDM sampling. `cond_scale_factor` is
    the concat latent's factor (VideoPredictionEmbedderWithEncoder has no
    scale_factor key in svd_xt.yaml: 1.0); `vae.scale_factor` divides the
    sampled latents before decoding. `height` x `width` is the published
    frame size (simple_video_sample.py)."""

    video_unet: VideoUNetConfig = field(default_factory=VideoUNetConfig)
    vae: VAEConfig = field(default_factory=VAEConfig)
    clip_image: CLIPImageEmbedConfig = field(
        default_factory=CLIPImageEmbedConfig)
    edm: EDMSamplerConfig = field(default_factory=EDMSamplerConfig)
    cond_scale_factor: float = 1.0
    height: int = 576
    width: int = 1024

    @property
    def default_sampling(self) -> Tuple[int, int, int]:
        """(height, width, steps) of a clip unless the caller sets them:
        the published frame size and the Euler steps."""
        return self.height, self.width, self.edm.steps


# configurations the entry points build by name (`--model`)
MODEL_PRESETS = {"dynamicrafter": PandoraConfig, "svd_xt": SVDConfig}


def model_config(name: str):
    """The default configuration of a model family by its preset name."""
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown model {name!r}; one of "
                       f"{sorted(MODEL_PRESETS)}")
    return MODEL_PRESETS[name]()


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
