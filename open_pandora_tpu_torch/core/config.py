"""Configuration of the DynamiCrafter image-to-video slice.

Counterpart of open_pandora_tpu/core/config.py for the sub-configs this
package uses, with the same fields and defaults: the shipped Open-Pandora
checkpoint (DynamiCrafter inference_512_v1.0.yaml).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


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
class PandoraConfig:
    """The sub-configs of the image-to-video slice."""

    vae: VAEConfig = field(default_factory=VAEConfig)
    unet: UNet3DConfig = field(default_factory=UNet3DConfig)
    clip_text: CLIPTextConfig = field(default_factory=CLIPTextConfig)
    clip_vision: CLIPVisionConfig = field(default_factory=CLIPVisionConfig)
    resampler: ResamplerConfig = field(default_factory=ResamplerConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
