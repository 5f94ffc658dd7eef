"""PyTorch port, the alternative encoders (models/encoders_extra.py) against
the JAX package on the CPU in fp32, each on the JAX weights carried across
by core/convert.py (a seeded NumPy tree of the JAX params' shapes): T5, the
HF CLIP text encoder in its three layer modes, the pooled CLIP image
encoder, the class embedder and the CLIP/T5 pair; the T5 bucket map; the
ucg semantics; strict loading of the transformers state dicts; the target
registry (core/registry.py) and the dtype policy (core/dtypes.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from open_pandora_tpu.core import config as jcfg
from open_pandora_tpu.core import dtypes as jdtypes
from open_pandora_tpu.core import registry as jregistry
from open_pandora_tpu.models import encoders_extra as jee
from open_pandora_tpu_torch import core as tcore
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.core import convert, dtypes, registry
from open_pandora_tpu_torch.models import encoders_extra as ee

# fp32 on both sides: relative to the largest |value| of the JAX output
REL = 1e-5

T5_KW = dict(vocab_size=97, d_model=32, d_kv=8, d_ff=48, num_layers=2,
             num_heads=4, relative_buckets=8, relative_max_distance=16)
CLIP_KW = dict(vocab_size=99, width=32, layers=2, heads=4,
               context_length=16, penultimate=False)
VIS_KW = dict(image_size=28, patch_size=14, width=64, layers=2, heads=2)
T5_IDS = np.array([[3, 14, 15, 92, 65, 35, 0, 0],
                   [8, 9, 7, 9, 3, 2, 3, 8]], np.int64)
# the eos (the largest id, 98) once a row: argmax pooling is unambiguous
CLIP_IDS = np.array([[49, 14, 15, 92, 98, 35, 1, 1],
                     [8, 9, 7, 98, 3, 2, 1, 1]], np.int64)


def seeded_params(module, *args, seed: int, **kw):
    """A tree of the JAX module's param shapes filled from NumPy: matrices
    std 0.1, norm scales 1 +- 0.05, other vectors 0 +- 0.05."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *args, **kw))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        r = rng.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if len(s.shape) >= 2:
            return r * np.float32(0.1)
        base = 1.0 if name == "scale" or "_ln" in name or name.endswith(
            "ln") else 0.0
        return np.float32(base) + r * np.float32(0.05)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _load(module, flat):
    module.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in flat.items()}, strict=True)
    return module.eval()


def _close(got, ref):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL * max(1.0, np.abs(ref).max()), err


# -- T5 -----------------------------------------------------------------------


def test_t5_encoder_matches_jax():
    jmod = jee.T5Encoder(jcfg.T5Config(**T5_KW))
    params = seeded_params(jmod, jnp.asarray(T5_IDS, jnp.int32), seed=1)
    ours = _load(ee.T5Encoder(tcfg.T5Config(**T5_KW)),
                 convert.t5_encoder_from_jax(params, tcfg.T5Config(**T5_KW)))
    ref = jmod.apply(params, jnp.asarray(T5_IDS, jnp.int32))
    with torch.no_grad():
        _close(ours(torch.from_numpy(T5_IDS)), ref)
    # the inverse of the JAX converter: its read of our keys gives params
    back = jee.convert_t5_encoder(
        {k: v.numpy() for k, v in ours.state_dict().items()},
        jcfg.T5Config(**T5_KW))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 16),
                                                  (64, 256)])
def test_relative_position_bucket_equals_jax(buckets, max_distance):
    rel = np.arange(-300, 301)
    ref = np.asarray(jee._relative_position_bucket(
        jnp.asarray(rel), buckets, max_distance))
    got = ee._relative_position_bucket(torch.from_numpy(rel), buckets,
                                       max_distance).numpy()
    np.testing.assert_array_equal(got, ref)


def test_t5_loads_transformers_state_dict_strictly():
    hf = transformers.T5EncoderModel(transformers.T5Config(
        vocab_size=97, d_model=32, d_kv=8, d_ff=48, num_layers=2,
        num_heads=4, relative_attention_num_buckets=8,
        relative_attention_max_distance=16, dropout_rate=0.0,
        feed_forward_proj="gated-gelu", is_encoder_decoder=False,
        use_cache=False)).eval()
    ours = ee.T5Encoder(tcfg.T5Config(**T5_KW)).eval()
    ours.load_state_dict(hf.state_dict(), strict=True)
    ids = torch.from_numpy(T5_IDS)
    with torch.no_grad():
        _close(ours(ids), hf(input_ids=ids).last_hidden_state.numpy())


# -- HF CLIP text -------------------------------------------------------------


@pytest.fixture(scope="module")
def clip_params():
    jmod = jee.HFCLIPTextEncoder(jcfg.CLIPTextConfig(**CLIP_KW))
    return seeded_params(jmod, jnp.asarray(CLIP_IDS, jnp.int32), seed=2)


@pytest.mark.parametrize("layer,layer_idx", [
    ("last", None), ("pooled", None), ("hidden", 0), ("hidden", 1),
    ("hidden", -1), ("hidden", -2)])
def test_hf_clip_text_matches_jax(clip_params, layer, layer_idx):
    jmod = jee.HFCLIPTextEncoder(jcfg.CLIPTextConfig(**CLIP_KW),
                                 layer=layer, layer_idx=layer_idx)
    ref = jmod.apply(clip_params, jnp.asarray(CLIP_IDS, jnp.int32))
    ours = _load(ee.HFCLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP_KW), layer,
                                      layer_idx),
                 convert.hf_clip_text_from_jax(
                     clip_params, tcfg.CLIPTextConfig(**CLIP_KW)))
    with torch.no_grad():
        _close(ours(torch.from_numpy(CLIP_IDS)), ref)


def test_hf_clip_text_loads_transformers_state_dict_strictly():
    hf = transformers.CLIPTextModel(transformers.CLIPTextConfig(
        vocab_size=99, hidden_size=32, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=16, hidden_act="quick_gelu",
        eos_token_id=98, attention_dropout=0.0)).eval()
    ours = ee.HFCLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP_KW)).eval()
    ours.load_state_dict(hf.state_dict(), strict=True)
    ids = torch.from_numpy(CLIP_IDS)
    with torch.no_grad():
        _close(ours(ids), hf(input_ids=ids).last_hidden_state.numpy())


def test_hf_clip_text_refuses_bad_layer():
    with pytest.raises(ValueError, match="last, pooled or hidden"):
        ee.HFCLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP_KW), "middle")
    with pytest.raises(ValueError, match="layer_idx"):
        ee.HFCLIPTextEncoder(tcfg.CLIPTextConfig(**CLIP_KW), "hidden")


# -- pooled CLIP image, class embedder, the pair ------------------------------

IMAGES = (np.random.default_rng(3).uniform(-1, 1, (2, 32, 40, 3))
          .astype(np.float32))


@pytest.fixture(scope="module")
def pooled():
    jmod = jee.PooledCLIPImageEncoder(jcfg.CLIPVisionConfig(**VIS_KW),
                                      output_dim=24)
    params = seeded_params(jmod, jnp.asarray(IMAGES), seed=4)
    ours = _load(ee.PooledCLIPImageEncoder(tcfg.CLIPVisionConfig(**VIS_KW),
                                           output_dim=24),
                 convert.pooled_clip_image_from_jax(params))
    return jmod, params, ours


def test_pooled_clip_image_matches_jax(pooled):
    jmod, params, ours = pooled
    with torch.no_grad():
        _close(ours(torch.from_numpy(IMAGES)),
               jmod.apply(params, jnp.asarray(IMAGES)))


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_pooled_clip_image_ucg(pooled, rate):
    """Rate 0 draws nothing and needs no generator; rate 1 zeroes every
    sample, as JAX's bernoulli at keep probability 0."""
    jmod, params, ours = pooled
    jmod = jmod.clone(ucg_rate=rate)
    ours.ucg_rate = rate
    x = torch.from_numpy(IMAGES)
    key = jax.random.PRNGKey(5) if rate else None
    ref = np.asarray(jmod.apply(params, jnp.asarray(IMAGES), key=key))
    gen = torch.Generator().manual_seed(5) if rate else None
    with torch.no_grad():
        got = ours(x, generator=gen)
    _close(got, ref)
    assert (np.abs(ref).max() == 0) == (rate == 1.0)
    if rate:
        with pytest.raises(ValueError, match="Generator"):
            ours(x)
        with torch.no_grad():
            assert ours(x, no_dropout=True).abs().max() > 0


@pytest.mark.parametrize("rate", [0.0, 1.0])
def test_class_embedder_matches_jax(rate):
    labels = np.array([0, 3, 7, 9, 2], np.int64)
    jmod = jee.ClassEmbedder(embed_dim=12, n_classes=10, ucg_rate=rate)
    params = seeded_params(jmod, jnp.asarray(labels, jnp.int32), seed=6,
                           disable_dropout=True)
    ours = _load(ee.ClassEmbedder(12, n_classes=10, ucg_rate=rate),
                 convert.class_embedder_from_jax(params))
    lab = torch.from_numpy(labels)
    with torch.no_grad():
        _close(ours(lab, disable_dropout=True),
               jmod.apply(params, jnp.asarray(labels, jnp.int32),
                          disable_dropout=True))
        key = jax.random.PRNGKey(7) if rate else None
        gen = torch.Generator().manual_seed(7) if rate else None
        ref = jmod.apply(params, jnp.asarray(labels, jnp.int32), key=key)
        _close(ours(lab, generator=gen), ref)
        if rate:   # every label dropped to the ucg class
            _close(ours(lab, generator=gen),
                   ours(ours.unconditional_labels(5), disable_dropout=True)
                   .numpy())
            with pytest.raises(ValueError, match="Generator"):
                ours(lab)
    np.testing.assert_array_equal(
        ours.unconditional_labels(3).numpy(),
        np.asarray(jmod.unconditional_labels(3)))


def test_clip_t5_pair_matches_jax():
    ccfg, tc = jcfg.CLIPTextConfig(**CLIP_KW), jcfg.T5Config(**T5_KW)
    jmod = jee.CLIPT5Pair(ccfg, tc)
    args = (jnp.asarray(CLIP_IDS, jnp.int32), jnp.asarray(T5_IDS, jnp.int32))
    params = seeded_params(jmod, *args, seed=8)
    ours = _load(ee.CLIPT5Pair(tcfg.CLIPTextConfig(**CLIP_KW),
                               tcfg.T5Config(**T5_KW)),
                 convert.clip_t5_pair_from_jax(
                     params, tcfg.CLIPTextConfig(**CLIP_KW),
                     tcfg.T5Config(**T5_KW)))
    ref = jmod.apply(params, *args)
    with torch.no_grad():
        got = ours(torch.from_numpy(CLIP_IDS), torch.from_numpy(T5_IDS))
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _close(g, r)


# -- registry and dtypes ------------------------------------------------------


@pytest.mark.parametrize("target", sorted(jregistry._TARGETS))
def test_registry_resolves_every_jax_target(target):
    """Each reference target resolves to a port callable at the JAX
    target's path and name, in the port's package."""
    fn = registry.resolve_target(target)
    assert callable(fn)
    mod, attr = jregistry._TARGETS[target].split(":")
    assert fn.__module__ == mod.replace("open_pandora_tpu",
                                        "open_pandora_tpu_torch", 1)
    assert fn.__name__ == attr
    assert registry._TARGETS.keys() == jregistry._TARGETS.keys()


def test_registry_unknown_target_and_build():
    for reg in (registry, jregistry):
        with pytest.raises(KeyError, match="unknown reference target"):
            reg.resolve_target("lvdm.nothing.Missing")
    from open_pandora_tpu_torch.models.unet3d import UNetModel

    ucfg = tcfg.UNet3DConfig(model_channels=32, channel_mult=(1,),
                             num_res_blocks=1, attention_resolutions=(1,),
                             num_head_channels=16, context_dim=32,
                             temporal_length=2)
    with torch.device("meta"):
        m = registry.build_from_target(
            {"target": "lvdm.modules.networks.openaimodel3d.UNetModel"},
            cfg=ucfg)
    assert isinstance(m, UNetModel) and m.cfg is ucfg
    emb = registry.build_from_target(
        {"target": "lvdm.modules.encoders.condition.ClassEmbedder",
         "params": {"embed_dim": 8, "n_classes": 10, "ucg_rate": 0.5}},
        ucg_rate=0.0)
    assert isinstance(emb, ee.ClassEmbedder) and emb.ucg_rate == 0.0
    for reg in (registry, jregistry):
        assert reg.build_from_target({"target": "torch.nn.Identity"}) is None
        assert reg.build_from_target({"target": "torch.nn.Identity"},
                                     x=42) == 42


@pytest.mark.parametrize("name", ["bf16", "bfloat16", "mixed", "fp32",
                                  "float32", "golden"])
def test_dtype_policy_names(name):
    ours, ref = dtypes.policy_from_name(name), jdtypes.policy_from_name(name)
    for field in ("param_dtype", "compute_dtype", "accum_dtype"):
        assert str(getattr(ours, field)).removeprefix("torch.") == \
            jnp.dtype(getattr(ref, field)).name
    x = torch.ones(3, dtype=torch.float16)
    assert ours.cast_compute(x).dtype == ours.compute_dtype
    assert ours.cast_accum(x).dtype == torch.float32
    y = torch.ones(3, dtype=ours.compute_dtype)
    assert ours.cast_compute(y) is y


def test_dtype_policy_unknown_and_exports():
    for mod in (dtypes, jdtypes):
        with pytest.raises(ValueError, match="unknown dtype policy 'fp8'"):
            mod.policy_from_name("fp8")
    assert tcore.DTypePolicy is dtypes.DTypePolicy
    assert tcore.default_policy() == dtypes.default_policy()
    assert tcore.golden_fp32_policy().param_dtype == torch.float32
    assert tcore.PandoraConfig is tcfg.PandoraConfig
    assert tcfg.T5Config() == tcfg.T5Config(**{
        f: getattr(jcfg.T5Config(), f)
        for f in jcfg.T5Config.__dataclass_fields__})
