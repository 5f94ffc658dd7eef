"""PyTorch port, ChatUniVi's LLM SFT stage, LoRA, the stages' freeze
policies and the 8-bit AdamW against the JAX package (tiny config, fp32,
CPU, the hash tokenizer):
  - the SFT data path: the lowered examples of synthetic conversations
    (text-only, <image> and <video> records) and their collated batches,
    exactly; build_labels, exactly;
  - sft_loss and its gradients, full and with LoRA adapters (rank 4), on a
    batch with mid-sequence pads, the weights a seeded tree of the JAX
    WorldModel's init shapes through `state_dict_from_jax`;
  - LoRA: a fresh adapter adds nothing, merging then a plain forward is
    the adapter forward, the converter carries the adapters, and the
    in-place graft is add_lora_params;
  - the trainable set of each stage, as parameter counts per JAX top-level
    key, equals JAX `trainable_partition`'s;
  - adamw8bit's updates, alone and behind the clip of make_optimizer."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from open_pandora_tpu.core.config import TrainConfig as JaxTrainConfig
from open_pandora_tpu.data import sft as jsft
from open_pandora_tpu.pipeline.tokenizers import HashFallbackTokenizer as JTok
from open_pandora_tpu.train import llm_step as jllm
from open_pandora_tpu.train import optim8bit as j8
from open_pandora_tpu.train.optim import (deep_merge, make_optimizer,
                                          trainable_partition as jpartition)
from open_pandora_tpu_torch.core import convert as tconvert
from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.data import sft as tsft
from open_pandora_tpu_torch.models import lora as tlora
from open_pandora_tpu_torch.models import world_model as twm
from open_pandora_tpu_torch.models.llama import LlamaForCausalLM, LoRALinear
from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config
from open_pandora_tpu_torch.pipeline.tokenizers import (
    HashFallbackTokenizer as TTok)
from open_pandora_tpu_torch.train import llm_step as tllm
from open_pandora_tpu_torch.train.optim import Optimizer, trainable_partition
from open_pandora_tpu_torch.train.optim8bit import (AdamW8bit, dequantize,
                                                    quantize)
from test_torch_world_slice import T, _prompts, make_world
from torch_parity import jax_config, max_abs

RANK, ALPHA = 4, 8.0
# fp32 on both sides: the loss within 1e-5 of itself, every gradient
# within 1e-3 of its own tensor's largest entry
LOSS_REL, GRAD_REL = 1e-5, 1e-3


def _lora_cfg():
    cfg = debug_world_config(T)
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, lora_rank=RANK, lora_alpha=ALPHA))


@pytest.fixture(scope="module")
def plain_world():
    return make_world(seed=47)


@pytest.fixture(scope="module")
def lora_world():
    return make_world(seed=48, cfg=_lora_cfg())


# -- the SFT data path ----------------------------------------------------------

def _records():
    recs = tsft.synthetic_conversations(8, 0)
    assert recs == jsft.synthetic_conversations(8, 0)
    return recs + [
        # chunk 0 of different lengths in one signature: mid-sequence pads
        {"conversations": [{"from": "human", "value": "look <image> now"},
                           {"from": "gpt", "value": "a dog runs"}]},
        {"conversations": [{"from": "human",
                            "value": "look very carefully <image> now"},
                           {"from": "gpt", "value": "two dogs"}]},
        # a video: 64 consecutive images, one VideoSegment
        {"conversations": [{"from": "human", "value": "what happens <video>"},
                           {"from": "gpt", "value": "the car turns"}]}]


def _segments_equal(js, ts):
    assert len(js) == len(ts)
    for a, b in zip(js, ts):
        assert type(a).__name__ == type(b).__name__
        if isinstance(b, twm.TokenSegment):
            assert np.array_equal(np.asarray(a.ids), b.ids.numpy())
            assert np.array_equal(np.asarray(a.mask), b.mask.numpy())
        elif isinstance(b, twm.ImageSegment):
            assert a.index == b.index
        else:
            assert a.indices == b.indices


def test_examples_and_collate_match_jax():
    cfg = debug_world_config(T)
    jcfg = jax_config(cfg)
    groups = {}
    for rec in _records():
        src = rec["conversations"]
        je = jsft.example_from_conversation(src, JTok())
        te = tsft.example_from_conversation(src, TTok())
        assert (te.chunk_ids, te.chunk_labels, te.n_images, te.is_video,
                te.signature) == (je.chunk_ids, je.chunk_labels, je.n_images,
                                  je.is_video, je.signature)
        groups.setdefault(te.signature, []).append((je, te))
    assert {s[2] for s in groups} == {False, True}     # images and a video
    assert any(s[0] == 1 for s in groups)              # text-only records
    for bucket in (None, 32):
        for pairs in groups.values():
            jb = jsft.collate_examples([j for j, _ in pairs], jcfg,
                                       bucket=bucket)
            tb = tsft.collate_examples([t for _, t in pairs], cfg,
                                       bucket=bucket)
            assert np.array_equal(np.asarray(jb["labels"]),
                                  tb["labels"].numpy())
            _segments_equal(jb["prompt"].segments, tb["prompt"].segments)
            assert np.array_equal(np.asarray(jb["prompt"].images),
                                  tb["prompt"].images.numpy())


def test_build_labels_match_jax(plain_world):
    cfg, jmodel, _, port = plain_world
    for bucket in (None, 8):
        jp, tp = _prompts(cfg, bucket)
        for supervise_from in (0, 1, 2):
            ref = jllm.build_labels(jmodel, jp, supervise_from)
            got = tllm.build_labels(port, tp, supervise_from)
            assert np.array_equal(np.asarray(ref), got.numpy())


# -- sft_loss, full and LoRA ------------------------------------------------------

def _sft_batches(cfg, jcfg):
    rng = np.random.default_rng(49)
    s = cfg.clip_tower.image_size
    srcs = _records()[8:10]
    images = [rng.standard_normal((1, s, s, 3)).astype(np.float32)
              for _ in srcs]
    jb = jsft.collate_examples([jsft.example_from_conversation(
        src["conversations"], JTok(), images=im)
        for src, im in zip(srcs, images)], jcfg)
    tb = tsft.collate_examples([tsft.example_from_conversation(
        src["conversations"], TTok(), images=im)
        for src, im in zip(srcs, images)], cfg)
    return jb, tb


def _llama_grads(grads, frozen, names):
    """JAX grads of the SFT stages under the port's parameter names (the
    frozen leaves as zeros, so the LoRA split converts whole)."""
    tree = deep_merge(grads, jax.tree_util.tree_map(jnp.zeros_like, frozen))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    out = {}
    tconvert.llama(out, tree["llama"], "video_model.model")
    tconvert.linear(out, "video_model.model.mm_projector",
                    tree["mm_projector"]["params"]["proj"])
    return {k: out[k] for k in names}


@pytest.mark.parametrize("lora", [False, True])
def test_sft_loss_and_grads_match_jax(plain_world, lora_world, lora):
    cfg, jmodel, params, port = lora_world if lora else plain_world
    stage = tllm.sft_stage(port)
    assert stage == ("llm_sft_lora" if lora else "llm_sft")
    jb, tb = _sft_batches(cfg, jax_config(cfg))
    trainable, frozen = jpartition(params, stage)
    (loss, aux), grads = jax.jit(jax.value_and_grad(
        functools.partial(jllm.sft_loss, jmodel), has_aux=True))(
        trainable, frozen, jb, jax.random.PRNGKey(0))
    mine, _ = trainable_partition(port, stage)
    got, metrics = tllm.sft_loss(port, tb)
    got.backward()
    assert int(metrics["n_supervised"]) == int(aux["n_supervised"]) > 0
    assert abs(float(got.detach()) - float(loss)) <= LOSS_REL * abs(float(loss))
    want = _llama_grads(grads, frozen, mine)
    if lora:
        assert all(tlora.is_adapter(k) or "mm_projector" in k for k in mine)
    for k, p in mine.items():
        scale = max(float(np.abs(want[k]).max()), 1e-6)
        assert max_abs(p.grad, want[k]) <= GRAD_REL * scale, k
    for p in port.parameters():
        p.grad = None


# -- LoRA ----------------------------------------------------------------------------

def _tiny_llamas():
    cfg = debug_world_config(T).llama
    plain = LlamaForCausalLM(cfg)
    lora = LlamaForCausalLM(dataclasses.replace(cfg, lora_rank=RANK,
                                                lora_alpha=ALPHA))
    lora.load_state_dict(tlora.add_lora_params(plain.state_dict(),
                                               lora.state_dict()))
    ids = torch.tensor([[1, 5, 9, 2, 7]])
    return plain, lora, ids


def test_lora_zero_delta_merge_and_graft():
    torch.manual_seed(0)
    plain, lora, ids = _tiny_llamas()
    with torch.no_grad():
        assert torch.equal(lora(ids), plain(ids))     # B = 0 at init
        for m in lora.modules():                      # a nonzero delta
            if isinstance(m, LoRALinear):
                m.lora_b.normal_(0.0, 0.05)
        adapted = lora(ids)
        assert max_abs(adapted, plain(ids)) > 1e-3
        merged = tlora.merge_lora_params(lora.state_dict(), ALPHA, RANK)
        assert merged.keys() == plain.state_dict().keys()
        plain.load_state_dict(merged)
        assert max_abs(plain(ids), adapted) <= 1e-5
    bad = dict(lora.state_dict())
    key = "model.layers.0.mlp.up_proj.weight"
    bad[key] = bad[key].to(torch.int8)
    with pytest.raises(ValueError, match="before int8"):
        tlora.merge_lora_params(bad, ALPHA, RANK)
    # the in-place graft: the same weight tensors, the LoRA layout, the
    # config's rank, and no change to the output
    plain, _, ids = _tiny_llamas()
    ptrs = {k: v.data_ptr() for k, v in plain.state_dict().items()}
    with torch.no_grad():
        before = plain(ids)
        tlora.add_lora_(plain, RANK, ALPHA, torch.Generator().manual_seed(1))
        assert torch.equal(plain(ids), before)
    sd = plain.state_dict()
    assert sd.keys() == lora.state_dict().keys()
    assert all(sd[k].data_ptr() == p for k, p in ptrs.items())
    assert plain.cfg.lora_rank == RANK


def test_convert_carries_adapters(lora_world):
    cfg, _, params, port = lora_world
    q = params["llama"]["params"]["model"]["layers_1"]["mlp"]["down_proj"]
    assert set(q) == {"base", "lora_a", "lora_b"}
    sd = port.state_dict()
    key = "video_model.model.layers.1.mlp.down_proj"
    assert np.array_equal(sd[f"{key}.lora_a"].numpy(), np.asarray(q["lora_a"]))
    assert np.array_equal(sd[f"{key}.lora_b"].numpy(), np.asarray(q["lora_b"]))
    assert np.array_equal(sd[f"{key}.weight"].numpy(),
                          np.asarray(q["base"]["kernel"]).T)


# -- the stages' trainable sets ------------------------------------------------------

# port module path -> the JAX WorldModel's top-level params key; the first
# match wins ("video_model." last: the tower and mm_projector sit inside it)
TOP_KEYS = (("diffusion_model.model.diffusion_model.", "unet"),
            ("diffusion_model.first_stage_model.", "vae"),
            ("diffusion_model.cond_stage_model.", "clip_text"),
            ("diffusion_model.embedder.", "clip_img"),
            ("diffusion_model.image_proj_model.", "resampler"),
            ("video_model.model.vision_tower.", "clip_tower"),
            ("video_model.model.mm_projector.", "mm_projector"),
            ("connector.", "connector"),
            ("video_model.", "llama"))


def _port_counts(named):
    out = {}
    for name, p in named.items():
        top = next(v for k, v in TOP_KEYS if name.startswith(k))
        out[top] = out.get(top, 0) + p.numel()
    return out


def _jax_counts(tree):
    return {k: sum(x.size for x in jax.tree_util.tree_leaves(v))
            for k, v in (tree or {}).items()}


@pytest.mark.parametrize("stage", ["alignment", "finetune", "llm_sft",
                                   "llm_sft_lora"])
def test_trainable_sets_match_jax(plain_world, lora_world, stage):
    _, _, params, port = lora_world if stage == "llm_sft_lora" \
        else plain_world
    assert _port_counts(dict(port.named_parameters())) == _jax_counts(params)
    jt, _ = jpartition(params, stage)
    trainable, frozen = trainable_partition(port, stage)
    assert _port_counts(trainable) == _jax_counts(jt)
    assert not any(k.startswith("video_model.model.vision_tower.")
                   for k in trainable)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())


# -- adamw8bit -----------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.standard_normal((70, 70)).astype(np.float32),
            "b": rng.standard_normal((300,)).astype(np.float32)}


def test_quantize_matches_jax():
    x = np.random.default_rng(50).standard_normal((5, 37)).astype(
        np.float32) * 3
    ref = j8._quantize(jnp.asarray(x), 16)
    got = quantize(torch.from_numpy(x), 16)
    assert np.array_equal(np.asarray(ref.q), got.q.numpy())
    assert np.array_equal(np.asarray(ref.scale), got.scale.numpy())
    assert np.array_equal(np.asarray(j8._dequantize(ref, x.shape, 16)),
                          dequantize(got, x.shape, 16).numpy())


@pytest.mark.parametrize("clipped", [False, True])
def test_adamw8bit_matches_jax(clipped):
    """Three updates on a seeded tree: AdamW8bit against optim8bit.adamw8bit
    (weight decay 0.01, 64-element blocks), and the port's Optimizer with
    optimizer=adamw8bit against make_optimizer's clip + adamw8bit. Both
    run the same fp32 steps: the parameters agree to 1e-6 of their
    scale."""
    rng = np.random.default_rng(51)
    p0 = _tree(rng)
    grads = [_tree(rng) for _ in range(3)]
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in p0.items()}
    if clipped:
        cfg = dict(optimizer="adamw8bit", learning_rate=1e-2,
                   grad_clip_norm=5.0, weight_decay=0.01)
        tx = make_optimizer(JaxTrainConfig(**cfg))
        opt = Optimizer(params, TrainConfig(**cfg))
        step = opt.step
    else:
        tx = j8.adamw8bit(1e-2, weight_decay=0.01, block_size=64)
        opt = AdamW8bit(list(params.values()), weight_decay=0.01,
                        block_size=64)
        step = functools.partial(opt.step, 1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                             state, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        step()
        for k, p in params.items():
            assert max_abs(p.detach(), jp[k]) <= 1e-6 * float(
                np.abs(p0[k]).max()), k
        assert max_abs(params["w"].detach(), p0["w"]) > 1e-3
    if not clipped:
        assert all(q.q.dtype == torch.int8 for q in opt.mu + opt.nu)
