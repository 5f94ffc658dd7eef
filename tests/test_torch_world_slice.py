"""PyTorch port, the LLM conditioning slice against the JAX package (tiny
config, fp32, CPU): the spliced prompt of a 2-round session, its
conditioning, bucketed against unbucketed text, and the alignment loss.
Weights are a seeded tree of the JAX WorldModel's init shapes, crossing to
the port through `state_dict_from_jax`.

The config is the port's `debug_world_config()`: the widths of the JAX
tests' `tiny_wm_cfg` (tests/test_llm_stack.py), but 16 patch tokens
clustered 8 -> 4 -> 3 where that one clusters 4 tokens 2 -> 1 -> 1. With
fewer clusters than neighbours k is clamped to 1, every density is
exp(-d(x, x)^2), and the centers hang on how each package rounds d(x, x):
no parity to hold there."""

import functools
import math

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from open_pandora_tpu.models import world_model as jwm
from open_pandora_tpu_torch.core.convert import state_dict_from_jax
from open_pandora_tpu_torch.models import world_model as twm
from open_pandora_tpu_torch.pipeline.chat_wm import (build_world_model,
                                                     debug_world_config)
from torch_parity import jax_config, max_abs

T = 4


def fill(path, s, rng):
    """Seeded values at realistic scales: kernels N(0, 1/fan_in), norm
    scales 1 +- 0.05, embeddings and prefix rows +- 0.5, the rest +- 0.05."""
    key = jtu.keystr(path)
    if len(s.shape) >= 2 and not key.endswith(("['embedding']",
                                               "['image_prefix']",
                                               "['query_tokens']",
                                               "['position_embedding']")):
        fan_in = math.prod(s.shape[:-1])
        return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(
            np.float32)
    base = 1.0 if key.endswith("['scale']") else 0.0
    spread = 0.5 if len(s.shape) >= 2 else 0.05
    return (base + spread * rng.standard_normal(s.shape)).astype(np.float32)


def make_world(seed=31, cfg=None):
    """(cfg, JAX WorldModel, its params, the port's WorldModel) on the same
    weights; cfg defaults to debug_world_config(T)."""
    cfg = cfg or debug_world_config(T)
    jmodel = jwm.WorldModel(jax_config(cfg))
    shapes = jax.eval_shape(
        functools.partial(jmodel.init_params, height=32, width=32),
        jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    params = jtu.tree_map_with_path(lambda p, s: fill(p, s, rng), shapes)
    port = build_world_model(cfg, device="cpu")
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          state_dict_from_jax(params, cfg).items()},
                         strict=True)
    return cfg, jmodel, jtu.tree_map(jnp.asarray, params), port


@pytest.fixture(scope="module")
def world():
    return make_world()


def _prompts(cfg, bucket=None):
    """The 2-round prompt (round 1's image, then 4 frames as a video) in
    both packages' segment types; with `bucket`, each text padded to it."""
    rng = np.random.default_rng(32)
    size = cfg.clip_tower.image_size
    images = rng.standard_normal((1, 1 + T, size, size, 3)).astype(np.float32)
    texts = [rng.integers(3, 31000, (1, n)) for n in (5, 3)]
    texts[0][0, 0] = 1                                        # bos
    masks = [None, None]
    if bucket:
        masks = [np.arange(bucket)[None] < t.shape[1] for t in texts]
        texts = [np.pad(t, ((0, 0), (0, bucket - t.shape[1])))
                 for t in texts]
    n_prefix = cfg.connector.image_prefix_length
    out = []
    for mod, arr in ((jwm, jnp.asarray), (twm, torch.from_numpy)):
        m = [None if x is None else arr(x) for x in masks]
        p = mod.round1_prompt(arr(texts[0]), images=arr(images),
                              prefix_len=n_prefix, text_mask=m[0])
        out.append(mod.next_round_prompt(p, range(1, 1 + T), arr(texts[1]),
                                         prefix_len=n_prefix,
                                         text_mask=m[1]))
    return out


def test_spliced_prompt_matches(world):
    cfg, jmodel, params, port = world
    jp, tp = _prompts(cfg)
    ref, jspans = jmodel.build_inputs_embeds(params, jp)
    with torch.no_grad():
        out, spans = port.build_inputs_embeds(tp)
    per_image = sum(cfg.cluster.spatial_rates)
    # bos, image, 4 text, prefix; video (one event), 3 text, prefix
    assert spans == jspans == [(1 + per_image + 4, 4),
                               (1 + 2 * per_image + 4 + 4 + 3, 4)]
    assert out.shape == ref.shape == (1, spans[-1][0] + 4,
                                      cfg.llama.hidden_size)
    assert [port.segment_length(s) for s in tp.segments] == \
        [jmodel.segment_length(s) for s in jp.segments]
    # clustered features through mm_projector: equal indices, fp32 sums
    assert max_abs(out, ref) <= 1e-5 * float(np.abs(ref).max())


def test_two_round_conditioning_matches(world):
    cfg, jmodel, params, port = world
    jp, tp = _prompts(cfg)
    ref = jmodel.get_diffusion_conditioning(params, jp)
    timings = {}
    with torch.no_grad():
        out = port.get_diffusion_conditioning(tp, timings=timings)
    assert out.shape == ref.shape == (1, 2, cfg.qformer.num_query_tokens,
                                      cfg.connector.proj_out_dim)
    # fp32 through tower, trunk and Q-Former: 1e-4 of the scale
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())
    assert float(np.abs(ref[0, 0] - ref[0, 1]).max()) > 1e-2   # rounds differ
    assert set(timings) == {"tower_s", "cluster_s", "prefill_s",
                            "connector_s", "prompt_len"}
    assert timings["prompt_len"] == 1 + 15 + 4 + 4 + 15 + 3 + 4


def test_bucketed_equals_unbucketed(world):
    """Text padded to a bucket, masked, with positions from the mask: the
    same conditioning as the exact-length prompt, and as the JAX package's
    bucketed one."""
    cfg, jmodel, params, port = world
    jp, tp = _prompts(cfg, bucket=8)
    _, exact = _prompts(cfg)
    ref = jmodel.get_diffusion_conditioning(params, jp)
    with torch.no_grad():
        out = port.get_diffusion_conditioning(tp)
        want = port.get_diffusion_conditioning(exact)
        assert port.attention_mask_for(exact) is None
        mask = port.attention_mask_for(tp)
    assert mask.shape == (1, 1 + 15 + 7 + 4 + 15 + 8 + 4)
    assert int(mask.sum()) == want.shape[0] * (1 + 15 + 4 + 4 + 15 + 3 + 4)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(jmodel.attention_mask_for(jp)))
    scale = float(np.abs(ref).max())
    assert max_abs(out, want) <= 1e-4 * scale
    assert max_abs(out, ref) <= 1e-4 * scale


def test_alignment_loss_matches(world):
    cfg, jmodel, params, port = world
    jp, tp = _prompts(cfg)
    caption = np.random.default_rng(33).integers(
        1, 49000, (1, cfg.clip_text.context_length))
    ref = float(jmodel.alignment_loss(params, jp,
                                      jnp.asarray(caption, jnp.int32)))
    out = port.alignment_loss(tp, torch.from_numpy(caption))
    assert ref > 1e-3
    assert abs(float(out) - ref) <= 1e-5 * max(1.0, ref)
    # the loss reaches the connector and, through the trunk, the prefix rows
    out.backward()
    assert float(port.connector.diffusion_proj.weight.grad.abs().max()) > 0
    assert float(port.connector.image_prefix.weight.grad.abs().max()) > 0
    port.zero_grad(set_to_none=True)


def test_generate_takes_the_last_round(world):
    """generate(): the last round's conditioning drives the synthesis; x_T
    and the noise injected, so it equals image_guided_synthesis on it."""
    cfg, _, _, port = world
    _, tp = _prompts(cfg)
    rng = np.random.default_rng(34)
    shape = (1, T, 16, 16, cfg.vae.z_channels)
    kw = dict(
        cond_images=torch.from_numpy(rng.random((1, 32, 32, 3), np.float32)),
        cond_frames=torch.from_numpy(
            rng.uniform(-1, 1, (1, 1, 32, 32, 3)).astype(np.float32)),
        ddim_steps=2, guidance_scale=4.0,
        x_T=torch.from_numpy(rng.standard_normal(shape, np.float32)),
        noise=[torch.from_numpy(rng.standard_normal(shape, np.float32))
               for _ in range(2)])
    with torch.no_grad():
        z = port.generate(tp, **kw)
        cond = port.get_diffusion_conditioning(tp)[:, -1]
        want = port.diffusion.image_guided_synthesis(text_context=cond, **kw)
    assert z.shape == shape and torch.equal(z, want)
