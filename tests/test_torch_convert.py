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
