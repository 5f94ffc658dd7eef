"""JAX params -> reference state dict, the inverse of
open_pandora_tpu/core/convert.py.

`state_dict_from_jax(params, cfg)` takes the params tree of the JAX
package's DynamiCrafter (NumPy leaves) and returns {reference key:
np.ndarray}: the dict `convert_dynamicrafter` reads, and the dict this
package's DynamiCrafter loads with load_state_dict(strict=True).

Leaf transforms (each the inverse of the forward converter's):
  Dense kernel (in, out)  -> Linear weight (out, in)   [Conv1d k=1: (out, in, 1)]
  conv2d kernel HWIO      -> weight OIHW
  conv3d kernel DHWIO     -> weight OIDHW
  norm scale / bias       -> weight / bias
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Flat = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def linear(out: Flat, prefix: str, p: Mapping, conv1d: bool = False) -> None:
    w = _a(p["kernel"]).T
    out[f"{prefix}.weight"] = _a(w[:, :, None] if conv1d else w)
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def conv2d(out: Flat, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _a(_a(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def conv3d(out: Flat, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _a(_a(p["kernel"]).transpose(4, 3, 0, 1, 2))
    if "bias" in p:
        out[f"{prefix}.bias"] = _a(p["bias"])


def norm(out: Flat, prefix: str, p: Mapping) -> None:
    out[f"{prefix}.weight"] = _a(p["scale"])
    out[f"{prefix}.bias"] = _a(p["bias"])


# -- open_clip towers ---------------------------------------------------------


def _resblock(out: Flat, lp: str, p: Mapping) -> None:
    norm(out, f"{lp}.ln_1", p["ln_1"])
    norm(out, f"{lp}.ln_2", p["ln_2"])
    out[f"{lp}.attn.in_proj_weight"] = _a(_a(p["attn_in_proj"]["kernel"]).T)
    out[f"{lp}.attn.in_proj_bias"] = _a(p["attn_in_proj"]["bias"])
    linear(out, f"{lp}.attn.out_proj", p["attn_out_proj"])
    linear(out, f"{lp}.mlp.c_fc", p["mlp_c_fc"])
    linear(out, f"{lp}.mlp.c_proj", p["mlp_c_proj"])


def _resblocks(out: Flat, prefix: str, p: Mapping) -> None:
    i = 0
    while f"resblocks_{i}" in p:
        _resblock(out, f"{prefix}.transformer.resblocks.{i}",
                  p[f"resblocks_{i}"])
        i += 1


def openclip_text(out: Flat, params: Mapping, prefix: str) -> None:
    p = params["params"]
    out[f"{prefix}.token_embedding.weight"] = _a(p["token_embedding"])
    out[f"{prefix}.positional_embedding"] = _a(p["positional_embedding"])
    norm(out, f"{prefix}.ln_final", p["ln_final"])
    _resblocks(out, prefix, p)


def openclip_visual(out: Flat, params: Mapping, prefix: str) -> None:
    p = params["params"]
    conv2d(out, f"{prefix}.conv1", p["conv1"])
    out[f"{prefix}.class_embedding"] = _a(p["class_embedding"])
    out[f"{prefix}.positional_embedding"] = _a(p["positional_embedding"])
    norm(out, f"{prefix}.ln_pre", p["ln_pre"])
    _resblocks(out, prefix, p)


def resampler(out: Flat, params: Mapping, prefix: str) -> None:
    p = params["params"]
    out[f"{prefix}.latents"] = _a(p["latents"])
    linear(out, f"{prefix}.proj_in", p["proj_in"])
    linear(out, f"{prefix}.proj_out", p["proj_out"])
    norm(out, f"{prefix}.norm_out", p["norm_out"])
    i = 0
    while f"layers_{i}_attn" in p:
        ap, fp, a = f"{prefix}.layers.{i}.0", f"{prefix}.layers.{i}.1", \
            p[f"layers_{i}_attn"]
        norm(out, f"{ap}.norm1", a["norm1"])
        norm(out, f"{ap}.norm2", a["norm2"])
        for name in ("to_q", "to_kv", "to_out"):
            linear(out, f"{ap}.{name}", a[name])
        norm(out, f"{fp}.0", p[f"layers_{i}_ff_norm"])
        linear(out, f"{fp}.1", p[f"layers_{i}_ff_1"])
        linear(out, f"{fp}.3", p[f"layers_{i}_ff_3"])
        i += 1


# -- UNet3D -------------------------------------------------------------------


def _resblock_unet(out: Flat, tp: str, p: Mapping) -> None:
    norm(out, f"{tp}.in_layers.0", p["in_norm"])
    conv2d(out, f"{tp}.in_layers.2", p["in_conv"])
    linear(out, f"{tp}.emb_layers.1", p["emb_layers_1"])
    norm(out, f"{tp}.out_layers.0", p["out_norm"])
    conv2d(out, f"{tp}.out_layers.3", p["out_conv"])
    if "skip_connection" in p:
        conv2d(out, f"{tp}.skip_connection", p["skip_connection"])
    if "temporal_conv" in p:
        tc, q = f"{tp}.temopral_conv", p["temporal_conv"]  # (sic)
        norm(out, f"{tc}.conv1.0", q["conv1_norm"])
        conv3d(out, f"{tc}.conv1.2", q["conv1"])
        for i in (2, 3, 4):
            norm(out, f"{tc}.conv{i}.0", q[f"conv{i}_norm"])
            conv3d(out, f"{tc}.conv{i}.3", q[f"conv{i}"])


def _transformer(out: Flat, tp: str, p: Mapping, conv1d: bool = False) -> None:
    norm(out, f"{tp}.norm", p["norm"])
    linear(out, f"{tp}.proj_in", p["proj_in"], conv1d=conv1d)
    linear(out, f"{tp}.proj_out", p["proj_out"], conv1d=conv1d)
    n = 0
    while f"transformer_blocks_{n}" in p:
        bp, blk = f"{tp}.transformer_blocks.{n}", p[f"transformer_blocks_{n}"]
        for name in ("norm1", "norm2", "norm3"):
            norm(out, f"{bp}.{name}", blk[name])
        for attn in ("attn1", "attn2"):
            a = blk[attn]
            for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
                if name in a:
                    linear(out, f"{bp}.{attn}.{name}", a[name])
            linear(out, f"{bp}.{attn}.to_out.0", a["to_out_0"])
            if "alpha" in a:
                out[f"{bp}.{attn}.alpha"] = _a(a["alpha"])
        linear(out, f"{bp}.ff.net.0.proj", blk["ff"]["net_0_proj"])
        linear(out, f"{bp}.ff.net.2", blk["ff"]["net_2"])
        n += 1


def unet(out: Flat, params: Mapping, cfg, prefix: str) -> None:
    """cfg: UNet3DConfig. Walks the block layout as convert_unet does."""
    p, pre = params["params"], prefix
    linear(out, f"{pre}.time_embed.0", p["time_embed_0"])
    linear(out, f"{pre}.time_embed.2", p["time_embed_2"])
    norm(out, f"{pre}.out.0", p["out_norm"])
    conv2d(out, f"{pre}.out.2", p["out_conv"])
    conv2d(out, f"{pre}.input_blocks.0.0", p["input_blocks_0_0"])
    if cfg.fs_condition:
        linear(out, f"{pre}.fps_embedding.0", p["fps_embedding_0"])
        linear(out, f"{pre}.fps_embedding.2", p["fps_embedding_2"])
    if cfg.addition_attention:
        # the reference builds init_attn with use_linear=False: Conv1d(k=1)
        _transformer(out, f"{pre}.init_attn.0", p["init_attn"], conv1d=True)

    block_idx, ds = 1, 1
    for level, _ in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            tp = f"{pre}.input_blocks.{block_idx}"
            _resblock_unet(out, f"{tp}.0", p[f"input_blocks_{block_idx}_0"])
            if ds in cfg.attention_resolutions:
                _transformer(out, f"{tp}.1", p[f"input_blocks_{block_idx}_1"])
                if cfg.temporal_attention:
                    _transformer(out, f"{tp}.2",
                                 p[f"input_blocks_{block_idx}_2"])
            block_idx += 1
        if level != len(cfg.channel_mult) - 1:
            conv2d(out, f"{pre}.input_blocks.{block_idx}.0.op",
                   p[f"input_blocks_{block_idx}_0"]["op"])
            block_idx += 1
            ds *= 2

    _resblock_unet(out, f"{pre}.middle_block.0", p["middle_block_0"])
    _transformer(out, f"{pre}.middle_block.1", p["middle_block_1"])
    pos = 2
    if cfg.temporal_attention:
        _transformer(out, f"{pre}.middle_block.2", p["middle_block_2"])
        pos = 3
    _resblock_unet(out, f"{pre}.middle_block.{pos}", p["middle_block_3"])

    block_idx = 0
    for level, _ in reversed(list(enumerate(cfg.channel_mult))):
        for i in range(cfg.num_res_blocks + 1):
            tp = f"{pre}.output_blocks.{block_idx}"
            _resblock_unet(out, f"{tp}.0", p[f"output_blocks_{block_idx}_0"])
            pos = 1
            if ds in cfg.attention_resolutions:
                _transformer(out, f"{tp}.1", p[f"output_blocks_{block_idx}_1"])
                pos = 2
                if cfg.temporal_attention:
                    _transformer(out, f"{tp}.2",
                                 p[f"output_blocks_{block_idx}_2"])
                    pos = 3
            if level and i == cfg.num_res_blocks:
                conv2d(out, f"{tp}.{pos}.conv",
                       p[f"output_blocks_{block_idx}_up"]["conv"])
                ds //= 2
            block_idx += 1


# -- VAE ----------------------------------------------------------------------


def _vae_resblock(out: Flat, tp: str, p: Mapping) -> None:
    for name in ("norm1", "norm2"):
        norm(out, f"{tp}.{name}", p[name])
    for name in ("conv1", "conv2", "nin_shortcut"):
        if name in p:
            conv2d(out, f"{tp}.{name}", p[name])


def _vae_mid(out: Flat, mp: str, p: Mapping) -> None:
    _vae_resblock(out, f"{mp}.block_1", p["mid_block_1"])
    _vae_resblock(out, f"{mp}.block_2", p["mid_block_2"])
    a = p["mid_attn_1"]
    norm(out, f"{mp}.attn_1.norm", a["norm"])
    for name in ("q", "k", "v", "proj_out"):
        conv2d(out, f"{mp}.attn_1.{name}", a[name])


def vae(out: Flat, params: Mapping, cfg, prefix: str) -> None:
    """cfg: VAEConfig."""
    p = params["params"]
    n_levels = len(cfg.channel_mult)
    for part in ("encoder", "decoder"):
        q, pp = p[part], f"{prefix}.{part}"
        conv2d(out, f"{pp}.conv_in", q["conv_in"])
        norm(out, f"{pp}.norm_out", q["norm_out"])
        conv2d(out, f"{pp}.conv_out", q["conv_out"])
        _vae_mid(out, f"{pp}.mid", q)
    enc, dec = p["encoder"], p["decoder"]
    for i in range(n_levels):
        for j in range(cfg.num_res_blocks):
            _vae_resblock(out, f"{prefix}.encoder.down.{i}.block.{j}",
                          enc[f"down_{i}_block_{j}"])
        if i != n_levels - 1:
            conv2d(out, f"{prefix}.encoder.down.{i}.downsample.conv",
                   enc[f"down_{i}_downsample"]["conv"])
        for j in range(cfg.num_res_blocks + 1):
            _vae_resblock(out, f"{prefix}.decoder.up.{i}.block.{j}",
                          dec[f"up_{i}_block_{j}"])
        if i != 0:
            conv2d(out, f"{prefix}.decoder.up.{i}.upsample.conv",
                   dec[f"up_{i}_upsample"]["conv"])
    conv2d(out, f"{prefix}.quant_conv", p["quant_conv"])
    conv2d(out, f"{prefix}.post_quant_conv", p["post_quant_conv"])


# -- composite ----------------------------------------------------------------


def state_dict_from_jax(params: Mapping, cfg) -> Flat:
    """DynamiCrafter params {'unet', 'vae', 'clip_text', 'clip_img',
    'resampler'} -> the standalone checkpoint's flat state dict. cfg:
    PandoraConfig (either package's)."""
    out: Flat = {}
    unet(out, params["unet"], cfg.unet, "model.diffusion_model")
    vae(out, params["vae"], cfg.vae, "first_stage_model")
    openclip_text(out, params["clip_text"], "cond_stage_model.model")
    openclip_visual(out, params["clip_img"], "embedder.model.visual")
    resampler(out, params["resampler"], "image_proj_model")
    return out
