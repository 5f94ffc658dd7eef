"""Key-coverage audit of the port's checkpoint loader against the released
checkpoint's surface.

Counterpart of open_pandora_tpu/tools/audit_ckpt_keys.py. It synthesizes
the key and shape surface of the released Open-Pandora WorldModel state
dict (reference model.py:69-113: video_model / diffusion_qformer, its
proj and query tokens / diffusion_proj / image_prefix / diffusion_model)
from the real torch module classes on the meta device, then checks what
eval/inference.load_checkpoint does with it in the port's WorldModel:

  1. every key of the surface is loaded into the WorldModel or matched
     by ALLOWED_UNUSED (schedule buffers, parameters the frozen
     embedders never read);
  2. the WorldModel's state dict holds exactly the surface's other keys,
     at the same shapes (no key missing, none extra).

The surface comes in two parts:
  - `hf_surface(cfg)`: the transformers families (LlamaForCausalLM,
    CLIPVisionModel, Blip2QFormerModel, on the meta device), the
    connector's layers, the open_clip towers' exact layout and the
    ddpm3d schedule buffers, at the widths of `cfg`;
  - `lvdm_surface(cfg, reference_dir)`: the reference lvdm UNetModel,
    AutoencoderKL and Resampler, imported from the reference DynamiCrafter
    checkout at `reference_dir` (the CLI reads the JAX tool's fixed
    REFERENCE_DIR); without its lvdm package, FileNotFoundError.
The LLaMA's vocabulary is the port's LLaMAConfig.total_vocab (the base
vocabulary and the 3 added tokens); the Q-Former's cross-attention reads
the projected LLM states (connector.qformer_proj_dim wide).

transformers is needed here, so the tool runs where it is installed (not
on the card's machine); the whole surface needs the reference checkout:

  python -m open_pandora_tpu_torch.tools.audit_ckpt_keys
"""

from __future__ import annotations

import argparse
import collections
import fnmatch
import os
import sys
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from open_pandora_tpu_torch.core.config import PandoraConfig

Shapes = Dict[str, Tuple[int, ...]]

# the reference DynamiCrafter checkout the JAX tool reads lvdm from (its
# fixed path, open_pandora_tpu/tools/audit_ckpt_keys.py:182)
REFERENCE_DIR = "/root/reference/DynamiCrafter"

# keys present in the released state dict that no model reads (the JAX
# tool's list, at PandoraConfig(): `allowed_unused` gives it at any depth)
ALLOWED_UNUSED = [
    # ddpm3d registered buffers (ddpm3d.py:141-181, 503-510)
    "diffusion_model.betas",
    "diffusion_model.alphas_cumprod*",
    "diffusion_model.sqrt_*",
    "diffusion_model.log_one_minus_alphas_cumprod",
    "diffusion_model.posterior_*",
    "diffusion_model.scale_arr",
    "diffusion_model.logvar",
    "diffusion_model.scale_factor",
    # open_clip params unused by the frozen embedders' forward
    # (condition.py:179-236 text: penultimate hidden state, no projection;
    # :300-382 visual V2: all tokens, no ln_post/proj)
    "diffusion_model.cond_stage_model.model.text_projection",
    "diffusion_model.cond_stage_model.model.logit_scale",
    "diffusion_model.cond_stage_model.model.transformer.resblocks.23.*",
    "diffusion_model.embedder.model.visual.proj",
    "diffusion_model.embedder.model.visual.ln_post.*",
    # HF vision tower: CLS-pooled head + final LN unused by the -2-layer
    # feature select (ChatUniVi clip_encoder.py hidden_states[-2])
    "video_model.model.vision_tower.vision_tower.vision_model.post_layernorm.*",
    "video_model.model.vision_tower.vision_tower.vision_model.encoder.layers.23.*",
    # Blip2QFormer text-branch FFN (query tokens only use *_query, HF
    # modeling_blip_2.py Blip2QFormerLayer.feed_forward_chunk_query)
    "diffusion_qformer.encoder.layer.*.intermediate.dense.*",
    "diffusion_qformer.encoder.layer.*.output.dense.*",
    "diffusion_qformer.encoder.layer.*.output.LayerNorm.*",
]

SCHEDULE_BUFFERS = (
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "scale_arr", "logvar")


def allowed_unused(cfg: PandoraConfig) -> List[str]:
    """ALLOWED_UNUSED with the last text block and the last tower layer
    (the unread ones) of `cfg`."""
    text = str(cfg.clip_text.layers - 1)
    tower = str(cfg.clip_tower.layers - 1)
    return [p.replace("resblocks.23.", f"resblocks.{text}.")
            .replace("encoder.layers.23.", f"encoder.layers.{tower}.")
            for p in ALLOWED_UNUSED]


def _shapes(mod: nn.Module, prefix: str) -> Shapes:
    return {prefix + k: tuple(v.shape) for k, v in mod.state_dict().items()}


def _openclip_block(width: int) -> nn.Module:
    """open_clip's resblock layout (nn.MultiheadAttention, c_fc/c_proj)."""
    blk = nn.Module()
    blk.ln_1 = nn.LayerNorm(width)
    blk.attn = nn.MultiheadAttention(width, 8)
    blk.ln_2 = nn.LayerNorm(width)
    blk.mlp = nn.Sequential(collections.OrderedDict([
        ("c_fc", nn.Linear(width, width * 4)), ("gelu", nn.GELU()),
        ("c_proj", nn.Linear(width * 4, width))]))
    return blk


def hf_surface(cfg: PandoraConfig) -> Shapes:
    """Every family of the surface but lvdm's, at the widths of `cfg`."""
    from transformers import (Blip2QFormerConfig, Blip2QFormerModel,
                              CLIPVisionConfig, CLIPVisionModel, LlamaConfig,
                              LlamaForCausalLM)

    L, T, Q = cfg.llama, cfg.clip_tower, cfg.qformer
    C = cfg.connector
    shapes: Shapes = {}
    with torch.device("meta"):
        # video_model: ChatUniViLlamaForCausalLM = HF llama + ViT-L tower +
        # mm_projector (ChatUniVi/model/arch.py:16)
        shapes.update(_shapes(LlamaForCausalLM(LlamaConfig(
            vocab_size=L.total_vocab, hidden_size=L.hidden_size,
            intermediate_size=L.intermediate_size,
            num_hidden_layers=L.num_layers,
            num_attention_heads=L.num_heads)), "video_model."))
        shapes.update(_shapes(CLIPVisionModel(CLIPVisionConfig(
            hidden_size=T.width, intermediate_size=int(T.width * T.mlp_ratio),
            num_hidden_layers=T.layers, num_attention_heads=T.heads,
            image_size=T.image_size, patch_size=T.patch_size)),
            "video_model.model.vision_tower.vision_tower."))
        shapes.update(_shapes(nn.Linear(T.width, L.hidden_size),
                              "video_model.model.mm_projector."))
        # the connector (model.py:77-92)
        shapes.update(_shapes(Blip2QFormerModel(Blip2QFormerConfig(
            hidden_size=Q.hidden_size, num_hidden_layers=Q.num_layers,
            num_attention_heads=Q.num_heads,
            intermediate_size=Q.intermediate_size,
            cross_attention_frequency=Q.cross_attention_frequency,
            encoder_hidden_size=C.qformer_proj_dim)), "diffusion_qformer."))
        shapes.update(_shapes(nn.Linear(C.llm_hidden, C.qformer_proj_dim),
                              "diffusion_qformer_proj."))
        shapes.update(_shapes(nn.Linear(Q.hidden_size, C.proj_out_dim),
                              "diffusion_proj."))
        shapes["diffusion_query_tokens"] = (1, Q.num_query_tokens,
                                            Q.hidden_size)
        shapes["image_prefix.weight"] = (C.image_prefix_length, C.llm_hidden)

        # open_clip text tower (all its blocks; the port runs layers - 1)
        tc = cfg.clip_text
        tp = "diffusion_model.cond_stage_model.model."
        shapes[tp + "token_embedding.weight"] = (tc.vocab_size, tc.width)
        shapes[tp + "positional_embedding"] = (tc.context_length, tc.width)
        shapes[tp + "text_projection"] = (tc.width, tc.width)
        shapes[tp + "logit_scale"] = ()
        for i in range(tc.layers):
            shapes.update(_shapes(_openclip_block(tc.width),
                                  f"{tp}transformer.resblocks.{i}."))
        shapes.update(_shapes(nn.LayerNorm(tc.width), tp + "ln_final."))
        # open_clip visual tower
        vc = cfg.clip_vision
        vp = "diffusion_model.embedder.model.visual."
        grid = vc.image_size // vc.patch_size
        shapes[vp + "conv1.weight"] = (vc.width, 3, vc.patch_size,
                                       vc.patch_size)
        shapes[vp + "class_embedding"] = (vc.width,)
        shapes[vp + "positional_embedding"] = (grid * grid + 1, vc.width)
        shapes[vp + "proj"] = (vc.width, tc.width)
        shapes.update(_shapes(nn.LayerNorm(vc.width), vp + "ln_pre."))
        shapes.update(_shapes(nn.LayerNorm(vc.width), vp + "ln_post."))
        for i in range(vc.layers):
            shapes.update(_shapes(_openclip_block(vc.width),
                                  f"{vp}transformer.resblocks.{i}."))
    # ddpm3d schedule buffers (ddpm3d.py:141-181, 503-510)
    for name in SCHEDULE_BUFFERS:
        shapes[f"diffusion_model.{name}"] = (cfg.diffusion.timesteps,)
    return shapes


def lvdm_surface(cfg: PandoraConfig, reference_dir: str) -> Shapes:
    """The reference lvdm UNet, VAE and Resampler at the widths of `cfg`
    (inference_512_v1.0.yaml's at PandoraConfig()), imported from the
    DynamiCrafter checkout at `reference_dir`."""
    if not os.path.isdir(os.path.join(reference_dir, "lvdm")):
        raise FileNotFoundError(
            f"{reference_dir}: the reference DynamiCrafter checkout (its "
            "lvdm package) is not there")
    if reference_dir not in sys.path:
        sys.path.insert(0, reference_dir)
    from lvdm.models.autoencoder import AutoencoderKL
    from lvdm.modules.encoders.resampler import Resampler
    from lvdm.modules.networks.openaimodel3d import UNetModel

    u, v, r = cfg.unet, cfg.vae, cfg.resampler
    shapes: Shapes = {}
    with torch.device("meta"):
        shapes.update(_shapes(UNetModel(
            in_channels=u.in_channels, out_channels=u.out_channels,
            model_channels=u.model_channels,
            attention_resolutions=list(u.attention_resolutions),
            num_res_blocks=u.num_res_blocks,
            channel_mult=list(u.channel_mult), dropout=0.1,
            num_head_channels=u.num_head_channels, transformer_depth=1,
            context_dim=u.context_dim, use_linear=True, use_checkpoint=True,
            temporal_conv=True, temporal_attention=True,
            temporal_selfatt_only=True, use_relative_position=False,
            use_causal_attention=False, temporal_length=u.temporal_length,
            addition_attention=True, image_cross_attention=True,
            default_fs=24, fs_condition=True),
            "diffusion_model.model.diffusion_model."))
        shapes.update(_shapes(AutoencoderKL(
            ddconfig=dict(double_z=True, z_channels=v.z_channels,
                          resolution=256, in_channels=3, out_ch=3,
                          ch=v.base_channels, ch_mult=list(v.channel_mult),
                          num_res_blocks=v.num_res_blocks,
                          attn_resolutions=[], dropout=0.0),
            lossconfig={"target": "torch.nn.Identity"},
            embed_dim=v.embed_dim), "diffusion_model.first_stage_model."))
        shapes.update(_shapes(Resampler(
            dim=r.dim, depth=r.depth, dim_head=r.dim_head, heads=r.heads,
            num_queries=r.num_queries, embedding_dim=r.embedding_dim,
            output_dim=r.output_dim, ff_mult=r.ff_mult,
            video_length=r.video_length),
            "diffusion_model.image_proj_model."))
    return shapes


def build_surface(cfg: PandoraConfig, reference_dir: str) -> Shapes:
    return {**hf_surface(cfg), **lvdm_surface(cfg, reference_dir)}


def audit(surface: Shapes, cfg: PandoraConfig, only=None) -> dict:
    """What load_checkpoint does with a checkpoint of `surface` in the
    port's WorldModel of `cfg` (on the meta device): the surface's keys it
    does not load, those of them ALLOWED_UNUSED does not cover, the model's
    keys the surface lacks, and the shapes that differ. `only` (key
    prefixes) restricts the model's side to those families."""
    from open_pandora_tpu_torch.eval.inference import missing_keys
    from open_pandora_tpu_torch.models.world_model import WorldModel

    with torch.device("meta"):
        wanted = {k: tuple(v.shape)
                  for k, v in WorldModel(cfg).state_dict().items()
                  if only is None or k.startswith(tuple(only))}
    allowed = allowed_unused(cfg)
    unconsumed = sorted(set(surface) - set(wanted))
    return {
        "surface": len(surface), "model": len(wanted),
        "consumed": len(surface) - len(unconsumed),
        "unconsumed": unconsumed,
        "unexpected": [k for k in unconsumed if not any(
            fnmatch.fnmatch(k, p) for p in allowed)],
        "missing": missing_keys(wanted, surface),
        "mismatched": sorted(k for k in set(wanted) & set(surface)
                             if wanted[k] != surface[k]),
    }


def report(rep: dict, surface: Shapes) -> bool:
    """Print the JAX tool's report; True when the audit passes."""
    print(f"[audit] synthetic released-checkpoint surface: "
          f"{rep['surface']} keys")
    print(f"[audit] consumed {rep['consumed']}/{rep['surface']} keys; "
          f"{len(rep['unconsumed'])} known-dead")
    if rep["unexpected"]:
        print("[audit] UNEXPECTED unconsumed keys:")
        for k in rep["unexpected"][:50]:
            print("   ", k, surface[k])
    print(f"[audit] target state dict: {rep['model']} keys; missing "
          f"{len(rep['missing'])}, shape-mismatched "
          f"{len(rep['mismatched'])}")
    for name in ("missing", "mismatched"):
        for k in rep[name][:25]:
            print(f"    {name}: {k}")
    ok = not (rep["unexpected"] or rep["missing"] or rep["mismatched"])
    print("[audit]", "PASS" if ok else "FAIL")
    return ok


def main(argv=None) -> int:
    argparse.ArgumentParser(
        "audit-ckpt-keys",
        description="the port's loader against the released checkpoint's "
                    "key surface (CPU; transformers and the reference "
                    "checkout)").parse_args(argv)
    cfg = PandoraConfig()
    surface = build_surface(cfg, REFERENCE_DIR)
    return 0 if report(audit(surface, cfg), surface) else 1


if __name__ == "__main__":
    sys.exit(main())
