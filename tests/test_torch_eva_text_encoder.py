"""PyTorch port, the EVA-ViT-g tower (models/eva_tower.py) and the CLIP
text transformer over the connector (models/encoders.py
`CLIPTextEmbeddingEncoder`) against the JAX package (small sizes, fp32,
CPU): each module on seeded JAX params carried across by
`state_dict_from_jax`'s converters, and the WorldModel's 2-round
conditioning with `tower_type="eva_vit_g"` and with
`use_diffusion_text_encoder=True`."""

import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from open_pandora_tpu.models.encoders import (
    CLIPTextEmbeddingEncoder as JaxTextEmbedding)
from open_pandora_tpu.models.eva_tower import EVAVisionTower as JaxEVA
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core import convert as tconvert
from open_pandora_tpu_torch.models.encoders import CLIPTextEmbeddingEncoder
from open_pandora_tpu_torch.models.eva_tower import EVAVisionTower
from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config
from test_torch_world_slice import T, _prompts, fill, make_world
from torch_parity import jax_sub_config, max_abs

EVA = tcfg.CLIPTowerConfig(image_size=56, patch_size=14, width=64, layers=3,
                           heads=2, select_layer=-2, tower_type="eva_vit_g",
                           mlp_ratio=4.3637)
TEXT = tcfg.CLIPTextConfig(width=64, layers=2, heads=2)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seeded(module, x, seed):
    """Seeded params of a JAX module's init shapes (test_torch_world_slice
    `fill`)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.default_rng(seed)
    return jtu.tree_map_with_path(lambda p, s: fill(p, s, rng), shapes)


def _load(module, convert, params, prefix="m"):
    flat = {}
    convert(flat, params, prefix)
    module.load_state_dict({k[len(prefix) + 1:]: torch.from_numpy(v)
                            for k, v in flat.items()}, strict=True)
    return module.eval()


@pytest.mark.parametrize("select_layer", [-2, -1, 0])
def test_eva_tower_matches_jax(select_layer):
    cfg = dataclasses.replace(EVA, select_layer=select_layer)
    x = np.random.default_rng(1).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    jtower = JaxEVA(jax_sub_config(cfg))
    params = _seeded(jtower, jnp.asarray(x), 2)
    ref = jtower.apply(jax.tree_util.tree_map(jnp.asarray, params),
                       jnp.asarray(x))
    port = _load(EVAVisionTower(cfg), tconvert.eva_tower, params)
    assert "blocks.0.attn.k_bias" not in port.state_dict()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 16, 64)      # cls dropped
    assert max_abs(out, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    assert port.n_run == {-2: 2, -1: 3, 0: 1}[select_layer]


def test_eva_full_width_shapes():
    """EVA-ViT-g at full width on the meta device: 39 blocks of 16 heads
    of 88, an MLP of 6144, 256 patches; select_layer -2 runs 38."""
    cfg = tcfg.CLIPTowerConfig(width=1408, layers=39, heads=16,
                               tower_type="eva_vit_g", mlp_ratio=4.3637)
    with torch.device("meta"):
        tower = EVAVisionTower(cfg)
        out = tower(torch.empty(2, 224, 224, 3))
    assert out.shape == (2, 256, 1408) and tower.n_run == 38
    assert tower.blocks[0].mlp.fc1.weight.shape == (6144, 1408)
    assert tower.pos_embed.shape == (1, 257, 1408)


def test_text_embedding_encoder_matches_jax():
    x = np.random.default_rng(3).standard_normal((3, 7, 64)).astype(
        np.float32)
    jenc = JaxTextEmbedding(jax_sub_config(TEXT))
    params = _seeded(jenc, jnp.asarray(x), 4)
    ref = jenc.apply(jax.tree_util.tree_map(jnp.asarray, params),
                     jnp.asarray(x))
    port = _load(CLIPTextEmbeddingEncoder(TEXT),
                 tconvert.text_embedding_encoder, params)
    assert len(port.transformer.resblocks) == TEXT.layers   # all of them
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert max_abs(out, ref) <= 1e-5 * max(1.0, float(np.abs(ref).max()))
    # causal: the first row sees only itself
    x2 = x.copy()
    x2[:, 1:] += 1.0
    with torch.no_grad():
        out2 = port(torch.from_numpy(x2))
    assert torch.equal(out2[:, 0], out[:, 0])


WORLDS = {
    "eva_vit_g": lambda c: dataclasses.replace(
        c, clip_tower=dataclasses.replace(
            c.clip_tower, tower_type="eva_vit_g", layers=3,
            mlp_ratio=4.3637)),
    "text_encoder": lambda c: dataclasses.replace(
        c, connector=dataclasses.replace(c.connector,
                                         use_diffusion_text_encoder=True)),
}


@pytest.mark.parametrize("kind", sorted(WORLDS))
def test_world_conditioning_matches_jax(kind):
    """The 2-round prompt's conditioning of test_torch_world_slice, with
    the EVA tower or the text transformer, within 1e-4 of the scale."""
    cfg = WORLDS[kind](debug_world_config(T))
    cfg, jmodel, params, port = make_world(seed=35, cfg=cfg)
    if kind == "eva_vit_g":
        assert isinstance(port.clip_tower, EVAVisionTower)
        assert port.mm_projector.weight.shape[1] == cfg.clip_tower.width
    else:
        assert isinstance(port.text_embedding_encoder,
                          CLIPTextEmbeddingEncoder)
    jp, tp = _prompts(cfg)
    ref = jmodel.get_diffusion_conditioning(params, jp)
    with torch.no_grad():
        out = port.get_diffusion_conditioning(tp)
    assert out.shape == ref.shape
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())
