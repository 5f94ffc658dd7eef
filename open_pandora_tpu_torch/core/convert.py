"""JAX params -> reference state dict, the inverse of
open_pandora_tpu/core/convert.py.

`state_dict_from_jax(params, cfg)` takes the params tree of the JAX
package's DynamiCrafter (NumPy leaves) and returns {reference key:
np.ndarray}: the dict `convert_dynamicrafter` reads, and the dict this
package's DynamiCrafter loads with load_state_dict(strict=True). A tree
that also holds the LLM-side families ('llama', 'clip_tower',
'mm_projector', 'connector') is the WorldModel's: the result is the dict
`convert_world_model` reads and this package's WorldModel loads: with the
EVA tower (`tower_type` "eva_vit_g"), the text transformer over the
connector ('text_embedding_encoder') and a weight-only quantized LLaMA
(models/quant.py) as the WorldModel of that config builds them.

Leaf transforms (each the inverse of the forward converter's):
  Dense kernel (in, out)  -> Linear weight (out, in)   [Conv1d k=1: (out, in, 1)]
  int8 kernel_q (in, out), scale (out,) -> weight_q (out, in), scale
  NF4 kernel_p (in/2, out), absmax (in/64, out) -> weight_p (out, in/2),
      absmax (out, in/64); the two codes of a byte stay as they are
  conv2d kernel HWIO      -> weight OIHW
  conv3d kernel DHWIO     -> weight OIDHW
  norm scale / bias       -> weight / bias   [RMSNorm: scale -> weight]
  embedding (vocab, dim)  -> weight, as it is

`normalize_state_dict` undoes a read checkpoint's `_forward_module.`
prefix and renamed keys, and the PL and DeepSpeed wrappers of a dict it
is handed whole (JAX convert.py:483). core.checkpoint.load_torch_flat
already unwraps each file it reads, as JAX checkpoint.py:29 does, since
it merges shard files into one flat dict.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Flat = Dict[str, np.ndarray]


def _a(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x))


def linear(out: Flat, prefix: str, p: Mapping, conv1d: bool = False) -> None:
    if "kernel_q" in p:
        out[f"{prefix}.weight_q"] = _a(_a(p["kernel_q"]).T)
        out[f"{prefix}.scale"] = _a(p["scale"])
        return
    if "kernel_p" in p:
        out[f"{prefix}.weight_p"] = _a(_a(p["kernel_p"]).T)
        out[f"{prefix}.absmax"] = _a(_a(p["absmax"]).T)
        return
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


# -- LLM side: LLaMA, CLIP ViT-L tower, Q-Former connector -------------------


def _lora_linear(out: Flat, prefix: str, p: Mapping) -> None:
    """A projection, plain or LoRA (JAX `LoRADense`: `base/kernel`,
    `lora_a` (in, r), `lora_b` (r, out)); the adapters keep their layout."""
    if "base" not in p:
        linear(out, prefix, p)
        return
    linear(out, prefix, p["base"])
    out[f"{prefix}.lora_a"] = _a(p["lora_a"])
    out[f"{prefix}.lora_b"] = _a(p["lora_b"])


def llama(out: Flat, params: Mapping, prefix: str) -> None:
    """models.llama.LlamaForCausalLM params, plain or with LoRA adapters
    -> HF keys under `prefix` (the LlamaModel); lm_head sits beside it."""
    p = params["params"]
    out[f"{prefix}.embed_tokens.weight"] = _a(p["embed_tokens"]["embedding"])
    out[f"{prefix}.norm.weight"] = _a(p["model"]["norm"]["scale"])
    i = 0
    while f"layers_{i}" in p["model"]:
        lp, q = f"{prefix}.layers.{i}", p["model"][f"layers_{i}"]
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _lora_linear(out, f"{lp}.self_attn.{name}", q["self_attn"][name])
        for name in ("gate_proj", "up_proj", "down_proj"):
            _lora_linear(out, f"{lp}.mlp.{name}", q["mlp"][name])
        for name in ("input_layernorm", "post_attention_layernorm"):
            out[f"{lp}.{name}.weight"] = _a(q[name]["scale"])
        i += 1
    if "lm_head" in p:
        head = prefix.rsplit(".", 1)[0] + "." if "." in prefix else ""
        linear(out, f"{head}lm_head", p["lm_head"])


def clip_tower(out: Flat, params: Mapping, prefix: str) -> None:
    """models.clip_tower.CLIPVisionTower params -> HF vision_model keys."""
    p = params["params"]
    conv2d(out, f"{prefix}.embeddings.patch_embedding", p["patch_embedding"])
    out[f"{prefix}.embeddings.class_embedding"] = _a(p["class_embedding"])
    out[f"{prefix}.embeddings.position_embedding.weight"] = _a(
        p["position_embedding"])
    norm(out, f"{prefix}.pre_layrnorm", p["pre_layrnorm"])
    i = 0
    while f"layers_{i}" in p:
        lp, q = f"{prefix}.encoder.layers.{i}", p[f"layers_{i}"]
        norm(out, f"{lp}.layer_norm1", q["layer_norm1"])
        norm(out, f"{lp}.layer_norm2", q["layer_norm2"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(out, f"{lp}.self_attn.{name}", q[name])
        linear(out, f"{lp}.mlp.fc1", q["fc1"])
        linear(out, f"{lp}.mlp.fc2", q["fc2"])
        i += 1


def eva_tower(out: Flat, params: Mapping, prefix: str) -> None:
    """models.eva_tower.EVAVisionTower params -> the reference EVA keys."""
    p = params["params"]
    conv2d(out, f"{prefix}.patch_embed.proj", p["patch_embed"])
    out[f"{prefix}.cls_token"] = _a(p["cls_token"])
    out[f"{prefix}.pos_embed"] = _a(p["pos_embed"])
    i = 0
    while f"blocks_{i}" in p:
        bp, q = f"{prefix}.blocks.{i}", p[f"blocks_{i}"]
        norm(out, f"{bp}.norm1", q["norm1"])
        norm(out, f"{bp}.norm2", q["norm2"])
        out[f"{bp}.attn.qkv.weight"] = _a(_a(q["qkv_kernel"]).T)
        out[f"{bp}.attn.q_bias"] = _a(q["q_bias"])
        out[f"{bp}.attn.v_bias"] = _a(q["v_bias"])
        linear(out, f"{bp}.attn.proj", q["proj"])
        linear(out, f"{bp}.mlp.fc1", q["mlp_fc1"])
        linear(out, f"{bp}.mlp.fc2", q["mlp_fc2"])
        i += 1


def text_embedding_encoder(out: Flat, params: Mapping, prefix: str) -> None:
    """models.encoders.CLIPTextEmbeddingEncoder params -> its resblocks
    and ln_final under `prefix`."""
    norm(out, f"{prefix}.ln_final", params["params"]["ln_final"])
    _resblocks(out, prefix, params["params"])


def qformer(out: Flat, p: Mapping, prefix: str) -> None:
    """models.connector.QFormer params (no 'params' level) -> HF
    Blip2QFormerModel keys."""
    norm(out, f"{prefix}.layernorm", p["layernorm"])

    def bert_attn(ap: str, a: Mapping) -> None:
        for name in ("query", "key", "value"):
            linear(out, f"{ap}.attention.{name}", a[name])
        linear(out, f"{ap}.output.dense", a["output_dense"])
        norm(out, f"{ap}.output.LayerNorm", a["output_layernorm"])

    i = 0
    while f"layer_{i}" in p:
        lp, q = f"{prefix}.encoder.layer.{i}", p[f"layer_{i}"]
        bert_attn(f"{lp}.attention", q["attention"])
        if "crossattention" in q:
            bert_attn(f"{lp}.crossattention", q["crossattention"])
        linear(out, f"{lp}.intermediate_query.dense", q["intermediate_query"])
        linear(out, f"{lp}.output_query.dense", q["output_query"])
        norm(out, f"{lp}.output_query.LayerNorm", q["output_query_layernorm"])
        i += 1


def connector(out: Flat, params: Mapping) -> None:
    """models.connector.Connector params -> the checkpoint's top-level
    keys."""
    p = params["params"]
    out["image_prefix.weight"] = _a(p["image_prefix"])
    linear(out, "diffusion_qformer_proj", p["qformer_proj"])
    out["diffusion_query_tokens"] = _a(_a(p["query_tokens"])[None])
    qformer(out, p["qformer"], "diffusion_qformer")
    linear(out, "diffusion_proj", p["proj"])


# -- the alternative encoders (models/encoders_extra.py) ----------------------


def t5_encoder_from_jax(params: Mapping, cfg) -> Flat:
    """JAX T5Encoder params -> the transformers T5EncoderModel keys (the
    inverse of JAX `convert_t5_encoder`); `encoder.embed_tokens` is tied
    to `shared`, as in transformers."""
    p = params["params"]
    out: Flat = {"shared.weight": _a(p["shared_embedding"])}
    out["encoder.embed_tokens.weight"] = out["shared.weight"]
    out["encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
        ".weight"] = _a(p["relative_attention_bias"])
    out["encoder.final_layer_norm.weight"] = _a(p["final_ln"])
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}.layer"
        out[f"{pre}.0.layer_norm.weight"] = _a(p[f"block_{i}_ln0"])
        out[f"{pre}.1.layer_norm.weight"] = _a(p[f"block_{i}_ln1"])
        for nm in ("q", "k", "v", "o"):
            linear(out, f"{pre}.0.SelfAttention.{nm}",
                   p[f"block_{i}_attn"][nm])
        for jx, nm in (("wi0", "wi_0"), ("wi1", "wi_1"), ("wo", "wo")):
            linear(out, f"{pre}.1.DenseReluDense.{nm}", p[f"block_{i}_{jx}"])
    return out


def hf_clip_text_from_jax(params: Mapping, cfg) -> Flat:
    """JAX HFCLIPTextEncoder params -> the transformers CLIPTextModel keys
    (the inverse of JAX `convert_hf_clip_text`)."""
    p = params["params"]
    base = "text_model."
    out: Flat = {
        base + "embeddings.token_embedding.weight": _a(p["token_embedding"]),
        base + "embeddings.position_embedding.weight":
            _a(p["position_embedding"]),
    }
    norm(out, base + "final_layer_norm", p["ln_final"])
    for i in range(cfg.layers):
        pre, b = f"{base}encoder.layers.{i}.", p[f"layers_{i}"]
        norm(out, pre + "layer_norm1", b["ln_1"])
        norm(out, pre + "layer_norm2", b["ln_2"])
        linear(out, pre + "mlp.fc1", b["mlp_fc1"])
        linear(out, pre + "mlp.fc2", b["mlp_fc2"])
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(out, pre + f"self_attn.{nm}", b[nm])
    return out


def class_embedder_from_jax(params: Mapping) -> Flat:
    return {"embedding.weight": _a(params["params"]["embedding"])}


def pooled_clip_image_from_jax(params: Mapping) -> Flat:
    """JAX PooledCLIPImageEncoder params -> `visual.*` (the open_clip
    tower), `ln_post.*` and `proj`."""
    p = params["params"]
    out: Flat = {"proj": _a(p["proj"])}
    openclip_visual(out, {"params": p["visual"]}, "visual")
    norm(out, "ln_post", p["ln_post"])
    return out


def clip_t5_pair_from_jax(params: Mapping, clip_cfg, t5_cfg) -> Flat:
    p = params["params"]
    out = {f"clip.{k}": v for k, v in hf_clip_text_from_jax(
        {"params": p["clip"]}, clip_cfg).items()}
    out.update({f"t5.{k}": v for k, v in t5_encoder_from_jax(
        {"params": p["t5"]}, t5_cfg).items()})
    return out


# -- composite ----------------------------------------------------------------

_TOWER = "video_model.model.vision_tower.vision_tower.vision_model"
_EVA_TOWER = "video_model.model.vision_tower.vision_tower"


def state_dict_from_jax(params: Mapping, cfg) -> Flat:
    """DynamiCrafter params {'unet', 'vae', 'clip_text', 'clip_img',
    'resampler'} -> the standalone checkpoint's flat state dict; with
    'llama', 'clip_tower', 'mm_projector' and 'connector' beside them, the
    WorldModel's params -> the released composite's (the diffusion families
    under `diffusion_model.`). cfg: PandoraConfig (either package's)."""
    out: Flat = {}
    world = "llama" in params
    pre = "diffusion_model." if world else ""
    unet(out, params["unet"], cfg.unet, f"{pre}model.diffusion_model")
    vae(out, params["vae"], cfg.vae, f"{pre}first_stage_model")
    openclip_text(out, params["clip_text"], f"{pre}cond_stage_model.model")
    openclip_visual(out, params["clip_img"], f"{pre}embedder.model.visual")
    resampler(out, params["resampler"], f"{pre}image_proj_model")
    if world:
        llama(out, params["llama"], "video_model.model")
        if cfg.clip_tower.tower_type.startswith("eva_vit_g"):
            eva_tower(out, params["clip_tower"], _EVA_TOWER)
        else:
            clip_tower(out, params["clip_tower"], _TOWER)
        linear(out, "video_model.model.mm_projector",
               params["mm_projector"]["params"]["proj"])
        connector(out, params["connector"])
        if "text_embedding_encoder" in params:
            text_embedding_encoder(out, params["text_embedding_encoder"],
                                   "diffusion_text_encoder")
    return out


# -- dialect normalization ----------------------------------------------------


def normalize_state_dict(raw: Mapping) -> Dict:
    """Strip PL / DeepSpeed wrappers and rename keys, as JAX
    `normalize_state_dict` (reference utils_train.py:136-158): the
    `state_dict`, then `module` level; the `_forward_module.` prefix;
    `framestride_embed` -> `fps_embedding` (inference.py:39-44)."""
    if isinstance(raw.get("state_dict"), dict):
        raw = raw["state_dict"]
    if isinstance(raw.get("module"), dict):
        raw = raw["module"]
    out = {}
    for k, v in raw.items():
        k = k.removeprefix("_forward_module.")
        if "framestride_embed" in k:
            k = k.replace("framestride_embed", "fps_embedding")
        out[k] = v
    return out
