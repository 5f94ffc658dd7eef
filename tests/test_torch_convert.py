"""PyTorch port, weights: `state_dict_from_jax` is the exact inverse of the
JAX package's `convert_dynamicrafter`, its keys and shapes are the port
model's own (strict load), and the port's config defaults equal the JAX
package's."""

import dataclasses
import functools

import jax
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import config as jcfg
from open_pandora_tpu.core.convert import convert_dynamicrafter
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core.convert import state_dict_from_jax
from open_pandora_tpu_torch.eval.inference import (build_model, debug_config,
                                                   load_checkpoint)
from open_pandora_tpu_torch.models.dynamicrafter import DynamiCrafter
from torch_parity import jax_config


@pytest.fixture(scope="module")
def jax_params():
    """A params tree shaped exactly like the JAX DynamiCrafter's init (taken
    abstractly), filled with seeded NumPy values."""
    cfg = jax_config(debug_config())
    shapes = jax.eval_shape(
        functools.partial(JaxDC(cfg).init_params, height=32, width=32),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    return jtu.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_round_trip_is_exact(jax_params):
    cfg = debug_config()
    sd = state_dict_from_jax(jax_params, cfg)
    back = convert_dynamicrafter(sd, jax_config(cfg))
    flat_a = jtu.tree_flatten_with_path(jax_params)[0]
    flat_b = jtu.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jtu.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jtu.keystr(path))


def test_strict_load_into_port(jax_params):
    cfg = debug_config()
    sd = state_dict_from_jax(jax_params, cfg)
    model = build_model(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    got = model.state_dict()
    for key in ("model.diffusion_model.input_blocks.1.0.in_layers.0.weight",
                "model.diffusion_model.init_attn.0.proj_in.weight",
                "first_stage_model.decoder.mid.attn_1.q.weight",
                "cond_stage_model.model.transformer.resblocks.0.attn."
                "in_proj_weight",
                "embedder.model.visual.conv1.weight",
                "image_proj_model.layers.0.0.to_kv.weight"):
        np.testing.assert_array_equal(got[key].numpy(), sd[key], err_msg=key)
    # the reference builds init_attn's projections as Conv1d(k=1)
    assert got["model.diffusion_model.init_attn.0.proj_in.weight"].ndim == 3


def test_load_checkpoint_dialects(tmp_path, jax_params):
    """A PL-style checkpoint: {'state_dict': ...}, '_forward_module.'
    prefixes, the framestride_embed name and keys the model does not hold
    (schedule buffers) load; a key the model needs and the file lacks is an
    error."""
    cfg = debug_config()
    sd = {k: torch.from_numpy(v)
          for k, v in state_dict_from_jax(jax_params, cfg).items()}
    raw = {f"_forward_module.{k}".replace("fps_embedding",
                                          "framestride_embed"): v
           for k, v in sd.items()}
    raw["betas"] = torch.zeros(1000)
    path = tmp_path / "model.ckpt"
    torch.save({"state_dict": raw}, path)
    model = build_model(cfg, device="cpu")
    load_checkpoint(model, str(path))
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    raw.pop("_forward_module.image_proj_model.latents")
    torch.save({"state_dict": raw}, path)
    with pytest.raises(KeyError):
        load_checkpoint(model, str(path))


def test_released_structure_key_set():
    """At the shipped block layout and layer counts (narrow widths), the
    port's state-dict keys and shapes are what state_dict_from_jax emits
    for the JAX model's init tree."""
    cfg = tcfg.PandoraConfig(
        vae=tcfg.VAEConfig(base_channels=32),
        unet=tcfg.UNet3DConfig(model_channels=32, num_head_channels=16,
                               context_dim=32, temporal_length=4),
        clip_text=tcfg.CLIPTextConfig(vocab_size=100, width=32, heads=2),
        clip_vision=tcfg.CLIPVisionConfig(image_size=28, width=32, heads=2),
        resampler=tcfg.ResamplerConfig(dim=32, dim_head=16, heads=2,
                                       embedding_dim=32, output_dim=32,
                                       video_length=4))
    shapes = jax.eval_shape(
        functools.partial(JaxDC(jax_config(cfg)).init_params, height=64,
                          width=64), jax.random.PRNGKey(0))
    zeros = jtu.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = state_dict_from_jax(zeros, cfg)
    with torch.device("meta"):
        port = DynamiCrafter(cfg)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert want == {k: v.shape for k, v in sd.items()}
    assert len(port.cond_stage_model.model.transformer.resblocks) == 23


def test_config_defaults_match():
    ours, theirs = tcfg.PandoraConfig(), jcfg.PandoraConfig()
    for f in dataclasses.fields(ours):
        mine, ref = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            mine, ref = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert mine == ref, f.name


# -- the LLM-side families (WorldModel) --------------------------------------


@pytest.fixture(scope="module")
def world_params():
    """A params tree shaped like the JAX WorldModel's init, seeded values."""
    from open_pandora_tpu.models.world_model import WorldModel as JaxWM
    from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config

    cfg = debug_world_config()
    shapes = jax.eval_shape(
        functools.partial(JaxWM(jax_config(cfg)).init_params, height=32,
                          width=32), jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    return cfg, jtu.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def test_world_round_trip_is_exact(world_params):
    """convert_world_model(state_dict_from_jax(p)) == p, leaf for leaf, the
    four LLM-side families and the diffusion families under their
    `diffusion_model.` prefix."""
    from open_pandora_tpu.core.convert import convert_world_model

    cfg, params = world_params
    sd = state_dict_from_jax(params, cfg)
    back = convert_world_model(sd, jax_config(cfg))
    flat_a = jtu.tree_flatten_with_path(params)[0]
    flat_b = jtu.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (path, a), (_, b) in zip(flat_a, flat_b):
        assert a.shape == b.shape, jtu.keystr(path)
        np.testing.assert_array_equal(a, b, err_msg=jtu.keystr(path))
    assert {"llama", "clip_tower", "mm_projector", "connector"} <= set(back)


def test_world_strict_load_and_released_keys(world_params):
    """The port's WorldModel takes the converted dict with strict=True; its
    own state dict has exactly those keys, which are the released
    checkpoint's families'."""
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model

    cfg, params = world_params
    sd = state_dict_from_jax(params, cfg)
    wm = build_world_model(cfg, device="cpu")
    wm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    got = wm.state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in sd.items()}
    tower = "video_model.model.vision_tower.vision_tower.vision_model"
    for key in ("video_model.model.embed_tokens.weight",
                "video_model.model.layers.1.self_attn.q_proj.weight",
                "video_model.model.norm.weight", "video_model.lm_head.weight",
                f"{tower}.embeddings.patch_embedding.weight",
                f"{tower}.embeddings.position_embedding.weight",
                f"{tower}.pre_layrnorm.bias",
                f"{tower}.encoder.layers.0.mlp.fc1.weight",
                "video_model.model.mm_projector.weight",
                "image_prefix.weight", "diffusion_query_tokens",
                "diffusion_qformer_proj.bias",
                "diffusion_qformer.encoder.layer.0.crossattention.attention."
                "query.weight",
                "diffusion_qformer.encoder.layer.1.output_query.LayerNorm."
                "weight", "diffusion_proj.weight",
                "diffusion_model.model.diffusion_model.out.2.weight",
                "diffusion_model.first_stage_model.quant_conv.weight"):
        np.testing.assert_array_equal(got[key].numpy(), sd[key], err_msg=key)
    assert got["diffusion_query_tokens"].ndim == 3
    assert "diffusion_qformer.encoder.layer.1.crossattention.attention." \
        "query.weight" not in got
    # the parts under the JAX package's names
    assert wm.llama is wm.video_model and wm.diffusion is wm.diffusion_model
    assert wm.mm_projector.weight.shape == (cfg.llama.hidden_size,
                                            cfg.clip_tower.width)
    with pytest.raises(RuntimeError, match="image_prefix"):
        wm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                            if k != "image_prefix.weight"}, strict=True)


def test_random_init_leaves_nothing_zero(world_params):
    from open_pandora_tpu_torch.pipeline.chat_wm import build_world_model

    cfg, _ = world_params
    wm = build_world_model(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    for name, p in wm.named_parameters():
        assert torch.isfinite(p).all() and float(p.abs().max()) > 0, name


def _llm_path_case(kind):
    """(port cfg, JAX WorldModel, its seeded params) of the debug world
    with the EVA tower, the text transformer, or the int8 LLaMA (the
    float tree quantized by the JAX package's quantize_llama_params)."""
    from open_pandora_tpu.models.quant import quantize_llama_params
    from open_pandora_tpu.models.world_model import WorldModel as JaxWM
    from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config

    cfg = debug_world_config()
    if kind == "eva_vit_g":
        cfg = dataclasses.replace(cfg, clip_tower=dataclasses.replace(
            cfg.clip_tower, tower_type="eva_vit_g", mlp_ratio=4.3637))
    if kind == "text_encoder":
        cfg = dataclasses.replace(cfg, connector=dataclasses.replace(
            cfg.connector, use_diffusion_text_encoder=True))
    quant = "int8" if kind == "int8" else False
    jmodel = JaxWM(jax_config(cfg), quantize_llm=quant)
    shapes = jax.eval_shape(functools.partial(
        JaxWM(jax_config(cfg)).init_params, height=32, width=32),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    params = jtu.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        shapes)
    if quant:
        params["llama"] = quantize_llama_params(params["llama"], quant)
    return cfg, jmodel, params


@pytest.mark.parametrize("kind", ["eva_vit_g", "text_encoder", "int8"])
def test_llm_paths_build_and_match_jax(kind):
    """The three config paths that the port refused before it had them
    (tower_type="eva_vit_g", use_diffusion_text_encoder=True,
    quantize_llm="int8") build, load `state_dict_from_jax` strictly, and
    hold the JAX package's outputs: the tower's features, the text
    transformer's output, the quantized trunk's hidden states."""
    import jax.numpy as jnp
    from open_pandora_tpu.models.llama import LlamaForCausalLM as JaxLlama
    from open_pandora_tpu_torch.models.world_model import WorldModel

    cfg, jmodel, params = _llm_path_case(kind)
    sd = state_dict_from_jax(params, cfg)
    with torch.device("meta"):
        wm = WorldModel(cfg, quantize_llm="int8" if kind == "int8" else False)
    wm = wm.to_empty(device="cpu").eval()
    wm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                       strict=True)
    rng = np.random.default_rng(3)
    p = jtu.tree_map(jnp.asarray, params)
    if kind == "eva_vit_g":
        x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
        ref = jmodel.encode_tower(p, jnp.asarray(x))
        with torch.no_grad():
            out = wm.encode_tower(torch.from_numpy(x))
        assert "video_model.model.vision_tower.vision_tower.blocks.0.attn." \
            "q_bias" in sd
    elif kind == "text_encoder":
        x = rng.standard_normal((2, 7, 64)).astype(np.float32)
        ref = jmodel.text_embedding_encoder.apply(
            p["text_embedding_encoder"], jnp.asarray(x))
        with torch.no_grad():
            out = wm.text_embedding_encoder(torch.from_numpy(x))
        assert "diffusion_text_encoder.ln_final.weight" in sd
    else:
        x = rng.standard_normal((1, 9, 64)).astype(np.float32)
        ref = jmodel.llama.apply(p["llama"], jnp.asarray(x),
                                 method=JaxLlama.trunk)
        with torch.no_grad():
            out = wm.llama.trunk(torch.from_numpy(x))
        assert wm.quantize_llm == "int8"
        assert sd["video_model.model.layers.0.mlp.up_proj.weight_q"].dtype \
            == np.int8
    assert out.shape == ref.shape
    assert float(np.abs(out.numpy() - np.asarray(ref)).max()) <= \
        1e-4 * max(1.0, float(np.abs(np.asarray(ref)).max()))
