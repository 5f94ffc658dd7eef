"""The port's training across processes: real gloo groups of 2 CPU ranks
(tests/torch_parallel_workers.py) against the JAX package's mesh step on
its 8-device CPU mesh and against the port's one-device step on the
global batch.

The ranks' cases: the DP + ZeRO-2 `dynamicrafter` step (fp32, dropout
off, the draws of JAX's key injected; AdamW and the 8-bit AdamW), the same
step with FSDP, the Optimizer's ZeRO-2 plan alone on equal gradients, an
`llm_sft` step with LoRA replicated and under FSDP, and trainer.run for 2
steps of `dynamicrafter` and of LoRA `llm_sft`, where rank 1 writes
nothing. One group runs them all (module fixture); each test reads its
case."""

import dataclasses
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_pandora_tpu.core.config import MeshConfig as JaxMeshConfig
from open_pandora_tpu.core.config import TrainConfig as JaxTrainConfig
from open_pandora_tpu.core.convert import convert_dynamicrafter
from open_pandora_tpu.models.dynamicrafter import DynamiCrafter as JaxDC
from open_pandora_tpu.parallel.mesh import build_mesh as jax_build_mesh
from open_pandora_tpu.train.step import TrainState as JaxTrainState
from open_pandora_tpu.train.step import make_finetune_step as jax_step_fn
from open_pandora_tpu_torch.core import convert as tconvert
from open_pandora_tpu_torch.core.config import TrainConfig
from open_pandora_tpu_torch.eval.inference import build_model, debug_config
from open_pandora_tpu_torch.pipeline.chat_wm import debug_world_config
import torch_parallel_workers as W
from torch_parity import jax_config, jax_finetune_draws, max_abs, rerandomize_

B, HW, WORLD = 2, 32, 2
TRAIN = dict(learning_rate=1e-4, uncond_prob=0.5, grad_clip_norm=0.5)
# the limits tests/test_torch_train_step.py holds the one-device step to:
# the loss within 1e-5 of itself, the gradient norm within 1e-4; an
# update within 1e-2 lr where the clipped gradient exceeds 100 eps, and
# within 2 lr (a flipped sign of a tiny gradient) everywhere
LOSS_REL, NORM_REL, BIG_LR, ALL_LR = 1e-5, 1e-4, 1e-2, 2 * (1 + 1e-3)


def _batch(cfg):
    rng = np.random.default_rng(21)
    t = cfg.unet.temporal_length
    return {
        "video": rng.uniform(-1, 1, (B, t, HW, HW, 3)).astype(np.float32),
        "cond_frames": rng.uniform(-1, 1, (B, 1, HW, HW, 3)).astype(
            np.float32),
        "cond_images": rng.random((B, 40, 48, 3), np.float32),
        "text_tokens": rng.integers(1, 49000, (B, 7)).astype(np.int32),
        "fps": np.asarray([8, 3], np.int32),
    }


def _no_dropout(rate, deterministic=None, **kw):
    return _FlaxDropout(0.0, deterministic=deterministic, **kw)


_FlaxDropout = flax.linen.Dropout


def _sft_cfg():
    cfg = debug_world_config()
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, lora_rank=4, lora_alpha=8.0))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The models are tiny: one intra-op thread keeps this process from
    competing for the cores with its process group and the suite's other
    workers (a module fixture, so that it covers `cases`)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(cpu_devices, tmp_path_factory):
    """The group's results, the JAX mesh step's, and the port's one-device
    results (the group runs while the test process computes the rest)."""
    import threading

    cfg = debug_config()
    flat = rerandomize_(build_model(cfg, device="cpu"), seed=11)
    batch = _batch(cfg)
    latent = (B, cfg.unet.temporal_length, HW // 2, HW // 2,
              cfg.vae.z_channels)
    jtcfg = JaxTrainConfig(**TRAIN)
    # a key whose CFG dropout mask keeps one sample's text and drops the
    # other's, one on each rank
    key = next(k for k in map(jax.random.PRNGKey, range(20))
               if jax_finetune_draws(k, 0.5, cfg.diffusion.timesteps, B,
                                     latent)["uncond"].sum() == 1)
    draws = jax_finetune_draws(key, 0.5, cfg.diffusion.timesteps, B, latent)
    logdir = str(tmp_path_factory.mktemp("runs"))
    group = {}

    def run():
        try:
            group["ranks"] = W.run_group(W.train_group, WORLD, flat, cfg,
                                         batch, draws, TRAIN, _sft_cfg(),
                                         logdir)
        except BaseException as e:   # re-raised in the test process
            group["error"] = e
    thread = threading.Thread(target=run)
    thread.start()

    jc = jax_config(cfg)
    jmodel = JaxDC(jc)
    jparams = jax.tree_util.tree_map(jnp.asarray,
                                     convert_dynamicrafter(flat, jc))
    mesh = jax_build_mesh(JaxMeshConfig(data_parallel=WORLD),
                          devices=cpu_devices[:WORLD])
    step, tx = jax_step_fn(jmodel, jtcfg, mesh_spec=mesh)
    state = step.shard_state(JaxTrainState.create(jparams, "dynamicrafter",
                                                  tx))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen, "Dropout", _no_dropout)
        new, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      key)
    unet = {}
    tconvert.unet(unet, jax.tree_util.tree_map(
        np.asarray, new.trainable["unet"]), cfg.unet, W.UNET)
    jax_ref = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "params": unet}
    one = {name: W.dc_step(flat, cfg, batch, draws,
                           TrainConfig(**TRAIN, **kw))
           for name, kw in (("adamw", {}),
                            ("adamw8bit", {"optimizer": "adamw8bit"}))}
    opt_one = {(name, opt): W.opt_steps(TrainConfig(
        optimizer=opt, learning_rate=1e-2, weight_decay=0.01,
        grad_clip_norm=clip))
        for name, clip in (("opt", 1e9), ("opt_clip", 0.5))
        for opt in ("adamw", "adamw8bit")}
    sft_one = W.sft_step(_sft_cfg(), 5, TrainConfig(learning_rate=1e-3,
                                                    grad_clip_norm=1.0))
    thread.join(W.GROUP_TIMEOUT_S + 30)
    assert not thread.is_alive(), "the process group did not finish"
    if "error" in group:
        raise group["error"]
    return {"ranks": group["ranks"], "jax": jax_ref, "one": one,
            "opt_one": opt_one, "sft_one": sft_one, "logdir": logdir,
            "flat": flat}


def _hold_update(got, want, grads, lr, old=None, eps=1e-8):
    """The update limits of tests/test_torch_train_step.py, with the
    one-device step's clipped gradients marking the large ones; with
    `old`, every parameter moved."""
    assert got.keys() == want.keys() == grads.keys()
    for k, g in grads.items():
        gap = np.abs(got[k] - want[k])
        big = np.abs(g) > 100 * eps
        assert gap[big].max(initial=0.0) < BIG_LR * lr, k
        assert gap.max() <= ALL_LR * lr, k
        if old is not None:
            assert max_abs(got[k], old[k]) > 0.5 * lr, k


@pytest.mark.parametrize("ref", ["jax_mesh", "one_device"])
def test_zero2_step_matches(cases, ref):
    """2 ranks, DP + ZeRO-2, AdamW: the loss (averaged over the ranks),
    the norm of the whole gradient and every updated UNet parameter
    against JAX's step on a 2-device mesh and against the port's step on
    one device, on the global batch with the same draws."""
    got = cases["ranks"][0]["zero2"]
    one = cases["one"]["adamw"]
    want = cases["jax"] if ref == "jax_mesh" else {
        **one["metrics"], "params": one["params"]}
    loss = got["metrics"]["loss"]
    assert abs(loss - want["loss"]) < LOSS_REL * want["loss"]
    assert abs(got["metrics"]["grad_norm"] - want["grad_norm"]) < \
        NORM_REL * want["grad_norm"]
    assert want["grad_norm"] > TRAIN["grad_clip_norm"]   # clip exercised
    old = {k: cases["flat"][k] for k in got["params"]}
    _hold_update(got["params"], want["params"], one["grads"],
                 TRAIN["learning_rate"], old)


def test_zero2_shards_and_gathers(cases):
    """ZeRO-2 split the large leaves (the others replicated), and after the
    all-gather both ranks hold the same parameters."""
    r0, r1 = (r["zero2"] for r in cases["ranks"])
    assert r0["kinds"]["shard"] > 0 and r0["kinds"]["rep"] > 0
    assert r0["kinds"]["fsdp"] == 0
    assert r0["digest"] == r1["digest"]


def test_zero2_8bit_step_matches_one_device(cases):
    """The same step with the 8-bit AdamW under ZeRO-2 against the 8-bit
    step on one device, by the same limits."""
    got = cases["ranks"][0]["zero2_8bit"]
    one = cases["one"]["adamw8bit"]
    assert got["kinds"]["shard"] > 0
    assert abs(got["metrics"]["loss"] - one["metrics"]["loss"]) < \
        LOSS_REL * one["metrics"]["loss"]
    old = {k: cases["flat"][k] for k in got["params"]}
    _hold_update(got["params"], one["params"], one["grads"],
                 TRAIN["learning_rate"], old)
    assert got["digest"] == cases["ranks"][1]["zero2_8bit"]["digest"]


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_optimizer_zero2_equals_one_device(cases, opt):
    """Three updates of the Optimizer over leaves ZeRO-2 takes every way
    (axis 0, axis 1, replicated, small), the gradients equal on both ranks:
    with the clip inactive the parameters, and for adamw8bit the int8
    moments, equal one device's exactly (its blocks are whole blocks of
    the unsharded flat leaf). With the clip active the norm, summed from
    the shards, is within 1e-6 of one device's, and so the parameters
    are for AdamW, within 1e-6 of each leaf's scale; for adamw8bit that
    last-bit difference can move a moment across an int8 code boundary,
    so there they are held to 1e-2 lr, the step tests' limit."""
    r0, r1 = (r["opt", opt] for r in cases["ranks"])
    one = cases["opt_one"]["opt", opt]
    assert r0["kinds"].count("shard") == (3 if opt == "adamw8bit" else 2)
    for k, v in one["params"].items():
        assert np.array_equal(r0["params"][k], v), k
        assert np.array_equal(r1["params"][k], v), k
    if opt == "adamw8bit":
        for moment in ("mu", "nu"):
            for i, kind in enumerate(r0["kinds"]):
                if kind == "shard":   # the two ranks' blocks, in order
                    joined = np.concatenate([r0[moment][i], r1[moment][i]])
                    n = one[moment][i].size
                    assert np.array_equal(joined[:n], one[moment][i])
                    assert not joined[n:].any()
                else:
                    assert np.array_equal(r0[moment][i], one[moment][i])
    c0 = cases["ranks"][0]["opt_clip", opt]
    c1 = cases["opt_one"]["opt_clip", opt]
    assert np.allclose(c0["norms"], c1["norms"], rtol=1e-6, atol=0)
    assert c1["norms"][0] > 0.5
    for k, v in c1["params"].items():
        limit = (BIG_LR * 1e-2 if opt == "adamw8bit"
                 else 1e-6 * float(np.abs(v).max()))
        assert max_abs(c0["params"][k], v) <= limit, k


@pytest.mark.parametrize("opt", ["adamw", "adamw8bit"])
def test_optimizer_one_data_rank_shards_nothing(cases, opt):
    """On a (1, 2) mesh the data axis has one rank, where a ZeRO-2 part
    would be the whole leaf: every leaf stays whole, and the three updates
    equal one device's exactly on both ranks."""
    one = cases["opt_one"]["opt", opt]
    for r in cases["ranks"]:
        got = r["opt_dp1", opt]
        assert set(got["kinds"]) == {"rep"}
        for k, v in one["params"].items():
            assert np.array_equal(got["params"][k], v), k


@pytest.mark.parametrize("case", ["fsdp", "fsdp_all"])
def test_fsdp_step_matches_replicated(cases, case):
    """fsdp=True: the large leaves stored sharded (FSDP2), the step's loss
    and updated parameters those of the replicated ZeRO-2 step (JAX
    tests/test_train_step.py:81 holds its FSDP step to atol 2e-6, rtol
    2e-5). `fsdp_all` splits every leaf that has an even axis, so each
    module's way of reading its weights meets a sharded one."""
    f0, f1 = (r[case] for r in cases["ranks"])
    rep = cases["ranks"][0]["zero2"]
    assert f0["kinds"]["fsdp"] > 0 and f0["n_sharded"] > f0["kinds"]["fsdp"]
    if case == "fsdp_all":
        assert f0["n_sharded"] > 5 * cases["ranks"][0]["fsdp"]["n_sharded"]
    assert abs(f0["metrics"]["loss"] - rep["metrics"]["loss"]) <= \
        2e-5 * rep["metrics"]["loss"]
    assert abs(f0["metrics"]["grad_norm"] - rep["metrics"]["grad_norm"]) \
        <= 2e-5 * rep["metrics"]["grad_norm"]
    for k, v in rep["params"].items():
        np.testing.assert_allclose(f0["params"][k], v, atol=2e-6, rtol=2e-5,
                                   err_msg=k)
    assert f0["digest"] == f1["digest"]


@pytest.mark.parametrize("case", ["sft", "sft_fsdp", "sft_fsdp_all"])
def test_llm_sft_lora_step_matches_one_device(cases, case):
    """An llm_sft step with LoRA over 2 ranks, replicated and under FSDP:
    the loss normalised by the global batch's supervised tokens, the
    gradient norm and the updated adapters and mm_projector against the
    one-device step on the global batch, by the limits above."""
    got = cases["ranks"][0][case]
    one = cases["sft_one"]
    lr = 1e-3
    if case != "sft":   # the frozen LLaMA's large leaves, or every leaf
        assert got["n_sharded"] > 0
    if case == "sft_fsdp_all":
        assert got["kinds"]["fsdp"] > 0
    m, w = got["metrics"], one["metrics"]
    assert m["n_supervised"] == w["n_supervised"] > 0
    assert abs(m["loss"] - w["loss"]) <= LOSS_REL * w["loss"]
    assert abs(m["grad_norm"] - w["grad_norm"]) <= NORM_REL * w["grad_norm"]
    assert any("lora_b" in k for k in got["params"])
    _hold_update(got["params"], one["params"], one["grads"], lr)


@pytest.mark.parametrize("run,stage", [("trainer", "dc"),
                                       ("trainer_sft", "sft")])
def test_trainer_runs_on_two_ranks(cases, run, stage):
    """trainer.run on 2 ranks, 2 steps (dynamicrafter; llm_sft with LoRA):
    both ranks finish, rank 0 wrote the workspace, the metrics of both
    steps once and the checkpoint, and rank 1 opened no file for writing
    and made no directory under the log directory."""
    (s0, w0), (s1, w1) = (r[run] for r in cases["ranks"])
    assert s0 == s1 == 2
    assert w1 == []
    root = os.path.join(cases["logdir"], stage)
    with open(os.path.join(root, "loginfo", "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 2
    assert os.path.exists(os.path.join(root, "checkpoints", "step_2",
                                       "params.pt"))
    assert os.path.exists(os.path.join(root, "configs", "config.json"))
