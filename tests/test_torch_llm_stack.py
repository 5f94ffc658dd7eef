"""PyTorch port, the modules of the LLM stack against the JAX package (small
sizes, fp32, CPU): the CLIP ViT-L tower, every DPC-KNN clustering function
(indices equal, merged tokens to 1e-5, with tie cases built on purpose), the
LLaMA trunk with and without a key mask, the Q-Former connector. Weights
are seeded NumPy values loaded into the port module and converted by the
JAX package's own converters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core import convert as jconvert
from open_pandora_tpu.models import cluster as jcluster
from open_pandora_tpu.models.clip_tower import CLIPVisionTower as JaxTower
from open_pandora_tpu.models.connector import Connector as JaxConnector
from open_pandora_tpu.models.llama import LlamaForCausalLM as JaxLlama
from open_pandora_tpu_torch.core import config as tcfg
from open_pandora_tpu_torch.models import cluster as tcluster
from open_pandora_tpu_torch.models.clip_tower import CLIPVisionTower
from open_pandora_tpu_torch.models.connector import Connector
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM
from torch_parity import jax_sub_config, max_abs, prefixed, rerandomize_, \
    to_jax

# -- CLIP ViT-L tower -----------------------------------------------------------


def test_clip_tower_matches():
    cfg = tcfg.CLIPTowerConfig(image_size=28, patch_size=14, width=64,
                               layers=3, heads=2)
    port = CLIPVisionTower(cfg).eval()
    assert len(port.encoder.layers) == 2        # select_layer -2: 2 of 3 run
    flat = rerandomize_(port, seed=1)
    params = to_jax(jconvert.convert_clip_tower(prefixed(flat, "vision_model"),
                                                2))
    x = np.random.default_rng(2).standard_normal((2, 28, 28, 3)).astype(
        np.float32)
    ref = JaxTower(jax_sub_config(cfg)).apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out.shape == ref.shape == (2, 4, 64)     # CLS dropped
    # fp32, two layers: summation order only
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())


# -- clustering -----------------------------------------------------------------


def _tokens(kind: str, rng, b=2, n=48, c=16):
    if kind == "random":
        return rng.standard_normal((b, n, c)).astype(np.float32)
    if kind == "blobs":         # three separated groups
        centers = rng.standard_normal((3, c)).astype(np.float32) * 4
        return (centers[rng.integers(0, 3, (b, n))]
                + 0.1 * rng.standard_normal((b, n, c))).astype(np.float32)
    # small integers: every distance is exact in fp32 on both sides, and
    # duplicated tokens tie in density and in score
    x = rng.integers(-2, 3, (b, n, c)).astype(np.float32)
    x[:, n // 2:] = x[:, :n - n // 2]
    return x


@pytest.mark.parametrize("kind", ["random", "blobs", "duplicates"])
@pytest.mark.parametrize("masked", [False, True])
def test_cluster_dpc_knn_indices_equal(kind, masked):
    rng = np.random.default_rng(3)
    x = _tokens(kind, rng)
    mask = None
    if masked:
        mask = np.ones(x.shape[:2], bool)
        mask[0, 5:20] = False
        mask[1, 30:] = False
    for cluster_num, k in ((8, 5), (3, 3), (16, 5)):
        ji, jc = jcluster.cluster_dpc_knn(
            jnp.asarray(x), cluster_num, k,
            None if mask is None else jnp.asarray(mask))
        ti, tc = tcluster.cluster_dpc_knn(
            torch.from_numpy(x), cluster_num, k,
            None if mask is None else torch.from_numpy(mask))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_cluster_exactly_cluster_num_members():
    """An event with exactly `cluster_num` unmasked tokens: every one is a
    center; the masked rest all score 0 and are assigned by first minimum."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 24, 8)).astype(np.float32)
    mask = np.zeros((1, 24), bool)
    mask[0, 4:12] = True
    ji, jc = jcluster.cluster_dpc_knn(jnp.asarray(x), 8, 3, jnp.asarray(mask))
    ti, tc = tcluster.cluster_dpc_knn(torch.from_numpy(x), 8, 3,
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert sorted(tc[0].tolist()) == list(range(4, 12))
    # more clusters than unmasked tokens: masked tokens become centers, the
    # lowest index first
    ji, jc = jcluster.cluster_dpc_knn(jnp.asarray(x), 12, 3,
                                      jnp.asarray(mask))
    ti, tc = tcluster.cluster_dpc_knn(torch.from_numpy(x), 12, 3,
                                      torch.from_numpy(mask))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tc[0, 8:].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("weighted", [False, True])
def test_merge_tokens_matches(weighted):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 30, 8)).astype(np.float32)
    idx = rng.integers(0, 6, (2, 30))
    idx[0][idx[0] == 4] = 0                      # an empty cluster
    w = rng.random((2, 30)).astype(np.float32) if weighted else None
    ref = jcluster.merge_tokens(jnp.asarray(x), jnp.asarray(idx), 6,
                                None if w is None else jnp.asarray(w))
    out = tcluster.merge_tokens(torch.from_numpy(x), torch.from_numpy(idx), 6,
                                None if w is None else torch.from_numpy(w))
    assert max_abs(out, ref) <= 1e-5
    assert float(out[0, 4].abs().max()) == 0.0   # 0 / 1e-6


@pytest.mark.parametrize("masked", [False, True])
def test_ctm_down_matches(masked):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 40, 16)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.random((2, 40)) < 0.6
    for cluster_num, k in ((8, 5), (2, 5)):      # k clamped for 2 clusters
        ref = jcluster.ctm_down(jnp.asarray(x), cluster_num, k,
                                None if mask is None else jnp.asarray(mask))
        out = tcluster.ctm_down(torch.from_numpy(x), cluster_num, k,
                                None if mask is None
                                else torch.from_numpy(mask))
        assert max_abs(out, ref) <= 1e-5


def test_project_image_tokens_matches():
    rng = np.random.default_rng(7)
    feats = rng.standard_normal((2, 64, 16)).astype(np.float32)
    ref = jcluster.project_image_tokens(jnp.asarray(feats), (16, 8, 4))
    out = tcluster.project_image_tokens(torch.from_numpy(feats), (16, 8, 4))
    assert out.shape == ref.shape == (2, 28, 16)
    assert max_abs(out, ref) <= 1e-5


@pytest.mark.parametrize("T,rate,kind", [(8, 0.25, "random"),
                                         (6, 0.5, "scenes"),
                                         (16, 1 / 16, "random"),
                                         (4, 0.5, "same")])
def test_project_video_tokens_matches(T, rate, kind):
    """Events ordered by first frame; "scenes" makes frames of three scenes
    out of order in time, "same" repeats one frame (an event may stay
    empty: all its tokens masked). With fewer clusters than neighbours k
    is clamped to 1, every density is exp(-d(x, x)^2) = 1 up to the
    rounding of d(x, x), and the centers hang on the 1e-6 tie-break: the
    scenes are kept small (|x|^2 / C about 0.1) so that rounding, about
    1e-7 |x|^2 / C in either package, stays below it."""
    rng = np.random.default_rng(8)
    frames = rng.standard_normal((T, 36, 16)).astype(np.float32)
    if kind == "scenes":
        scene = rng.standard_normal((3, 1, 16)).astype(np.float32) * 3
        frames = (frames * 0.3 + scene[[2, 0, 2, 1, 0, 1]]) * np.float32(0.1)
    elif kind == "same":
        frames[:] = frames[:1]
    ref = jcluster.project_video_tokens(jnp.asarray(frames), (8, 4, 2), rate)
    out = tcluster.project_video_tokens(torch.from_numpy(frames), (8, 4, 2),
                                        rate)
    assert out.shape == ref.shape
    assert max_abs(out, ref) <= 1e-5


# -- LLaMA ---------------------------------------------------------------------

LLAMA = tcfg.LLaMAConfig(vocab_size=97, hidden_size=64, intermediate_size=96,
                         num_layers=2, num_heads=4)


@pytest.fixture(scope="module")
def llamas():
    port = LlamaForCausalLM(LLAMA).eval()
    flat = rerandomize_(port, seed=9)
    params = to_jax(jconvert.convert_llama(flat, LLAMA.num_layers))
    return port, JaxLlama(jax_sub_config(LLAMA)), params


@pytest.mark.parametrize("masked", [False, True])
def test_llama_trunk_matches(llamas, masked):
    port, jmodel, params = llamas
    rng = np.random.default_rng(10)
    ids = rng.integers(0, LLAMA.total_vocab, (2, 13))
    mask = pos = None
    if masked:
        mask = np.ones((2, 13), bool)
        mask[0, 3:6] = False
        mask[1, 10:] = False
        pos = np.cumsum(mask, axis=1) - 1
    emb = jmodel.apply(params, jnp.asarray(ids), method=JaxLlama.embed)
    ref = jmodel.apply(
        params, emb, None if pos is None else jnp.asarray(pos, jnp.int32),
        None if mask is None else jnp.asarray(mask), method=JaxLlama.trunk)
    with torch.no_grad():
        temb = port.embed(torch.from_numpy(ids))
        out = port.trunk(temb, None if pos is None else torch.from_numpy(pos),
                         None if mask is None else torch.from_numpy(mask))
    assert max_abs(temb, emb) == 0.0
    # fp32, two layers: 1e-4 of the hidden states' scale; rows at masked
    # positions are pads on both sides and compared too
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())


def test_llama_logits_and_hf_keys(llamas):
    port, jmodel, params = llamas
    ids = np.random.default_rng(11).integers(0, LLAMA.total_vocab, (1, 7))
    ref = jmodel.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        out = port(torch.from_numpy(ids))
    assert out.shape == (1, 7, LLAMA.total_vocab)
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())
    keys = set(port.state_dict())
    assert {"model.embed_tokens.weight", "model.norm.weight",
            "lm_head.weight", "model.layers.1.self_attn.o_proj.weight",
            "model.layers.0.mlp.gate_proj.weight",
            "model.layers.0.post_attention_layernorm.weight"} <= keys


def test_long_unmasked_prompt_takes_the_flash_route():
    """ChatWM buckets its text, so its prefill is masked and plain; an
    unmasked prompt of 512 rows or more takes the flash forward's causal
    route on a CUDA device, as in the JAX package."""
    from open_pandora_tpu_torch.ops.attention import attention_route
    q = (1, 600, LLAMA.num_heads, 16)
    assert attention_route(q, q, causal=True, masked=False,
                           on_device=True) == "flash"
    assert attention_route(q, q, causal=True, masked=True,
                           on_device=True) == "plain"
    assert attention_route(q, q, causal=True, masked=False,
                           on_device=False) == "plain"


# -- connector ------------------------------------------------------------------


def test_connector_matches():
    qcfg = tcfg.QFormerConfig(hidden_size=32, num_layers=3, num_heads=2,
                              intermediate_size=64, num_query_tokens=7)
    ccfg = tcfg.ConnectorConfig(llm_hidden=64, image_prefix_length=4,
                                qformer_proj_dim=32, proj_out_dim=48)
    port = Connector(ccfg, qcfg).eval()
    # layers 0 and 2 cross-attend, layer 1 does not
    assert [hasattr(layer, "crossattention")
            for layer in port.diffusion_qformer.encoder.layer] == [
                True, False, True]
    flat = rerandomize_(port, seed=12)
    params = to_jax(jconvert.convert_connector(flat, qcfg))
    jmodel = JaxConnector(jax_sub_config(ccfg), jax_sub_config(qcfg))
    h = np.random.default_rng(13).standard_normal((3, 4, 64)).astype(
        np.float32)
    ref = jmodel.apply(params, jnp.asarray(h))
    with torch.no_grad():
        out = port(torch.from_numpy(h))
    assert out.shape == ref.shape == (3, 7, 48)
    # post-LN blocks with eps 1e-12 on fp32: 1e-4 of the scale
    assert max_abs(out, ref) <= 1e-4 * float(np.abs(ref).max())
    rows = jmodel.apply(params, method=JaxConnector.prefix_embeddings)
    assert max_abs(port.prefix_embeddings().detach(), rows) == 0.0
