"""PyTorch port, the trainer: the CLI end to end on the CPU (tiny config,
synthetic data, two steps, then an --auto-resume run to step 3) in a
process where importing jax fails, for every stage (dynamicrafter,
alignment, finetune, llm_sft full and with LoRA); the settings it
refuses and the mesh settings one process takes; load_config against the JAX
package's; the kernel launches of a full-width training step, traced on
the meta device through stand-in launchers, against chip_smoke's
prediction; and chip_smoke's launch prediction for the LLM stages."""

import collections
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from open_pandora_tpu_torch.core.checkpoint import find_latest_checkpoint
from open_pandora_tpu_torch.core.config import PandoraConfig, load_config
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.models.lora import is_adapter
from open_pandora_tpu_torch.ops import flash_attention as tfa
from open_pandora_tpu_torch.ops import small_attention as tsa
from open_pandora_tpu_torch.ops.attention import attention_route
from open_pandora_tpu_torch.ops.attention_xla import mha
from open_pandora_tpu_torch.train import trainer

REPO = Path(__file__).resolve().parent.parent


def _train(tmp_path, *extra, stage="dynamicrafter"):
    argv = ["--tiny", "--synthetic-data", "--device", "cpu", "--logdir",
            str(tmp_path), "--name", "run", "--set",
            f"train.stage={stage}", "--set", "train.log_every=1",
            *extra]
    code = ("import sys; sys.modules['jax'] = None; "
            "from open_pandora_tpu_torch.train.trainer import main; "
            f"assert main({argv!r}) == 0; "
            "assert not [m for m in sys.modules if sys.modules[m] is not None"
            " and m.split('.')[0] in ('jax', 'open_pandora_tpu')]")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
    with open(tmp_path / "run" / "loginfo" / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_trainer_cli_and_resume(tmp_path):
    recs = _train(tmp_path, "--max-steps", "2")
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(r[k] == r[k] and r[k] >= 0 for k in
                   ("loss", "loss_simple", "grad_norm", "sec_per_step"))
        assert r["grad_norm"] > 0
    ckpts = tmp_path / "run" / "checkpoints"
    assert find_latest_checkpoint(str(ckpts)) == str(ckpts / "step_2")
    saved = torch.load(ckpts / "step_2" / "params.pt", weights_only=True)
    assert saved and all(k.startswith("model.diffusion_model.")
                         for k in saved)
    # resume: the run continues from step 2's parameters to step 3
    recs = _train(tmp_path, "--max-steps", "3", "--auto-resume")
    assert [r["step"] for r in recs] == [1, 2, 3]
    assert find_latest_checkpoint(str(ckpts)) == str(ckpts / "step_3")
    after = torch.load(ckpts / "step_3" / "params.pt", weights_only=True)
    assert after.keys() == saved.keys()
    assert any(not torch.equal(after[k], saved[k]) for k in saved)
    assert (tmp_path / "run" / "configs" / "config.json").exists()


# the checkpoint holds the stage's trainable parameters: their prefixes
_LLAMA = ("video_model.model.embed_tokens.", "video_model.model.layers.",
          "video_model.model.norm.", "video_model.lm_head.")
_MM = ("video_model.model.mm_projector.",)


@pytest.mark.parametrize("stage,overrides,prefixes", [
    ("alignment", [], ("connector.",)),
    ("finetune", [], ("diffusion_model.model.diffusion_model.",
                      "connector.")),
    ("llm_sft", [], _LLAMA + _MM),
    ("llm_sft", ["llama.lora_rank=4"], _MM),
])
def test_llm_stage_cli_and_resume(tmp_path, stage, overrides, prefixes):
    extra = [a for o in overrides for a in ("--set", o)]
    recs = _train(tmp_path, "--max-steps", "2", *extra, stage=stage)
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("loss", "grad_norm"))
        assert r["grad_norm"] > 0
    ckpts = tmp_path / "run" / "checkpoints"
    saved = torch.load(ckpts / "step_2" / "params.pt", weights_only=True)
    lora = bool(overrides)
    # every key under the stage's prefixes, each prefix present; LoRA:
    # mm_projector and the adapters alone
    for key in saved:
        assert key.startswith(prefixes) or (lora and is_adapter(key)), key
    assert all(any(k.startswith(p) for k in saved) for p in prefixes)
    assert not lora or sum(map(is_adapter, saved)) == 2 * 7 * 2
    recs = _train(tmp_path, "--max-steps", "3", "--auto-resume", *extra,
                  stage=stage)
    assert [r["step"] for r in recs] == [1, 2, 3]
    after = torch.load(ckpts / "step_3" / "params.pt", weights_only=True)
    assert after.keys() == saved.keys()
    assert any(not torch.equal(after[k], saved[k]) for k in saved)


# the ids are those the cases had beside three that the port now runs
# (video SFT records, train.frame_stride and train.fixed_fps: WebVid data).
# Slice E (the mesh) is ported: a mesh of 2 in one process is refused as
# the JAX package's build_mesh refuses it, and the mesh settings that one
# process can take train.
@pytest.mark.parametrize("overrides,refusal", [
    pytest.param(["train.stage=dynamicrafter", "mesh.data_parallel=2"],
                 (ValueError, "mesh 2x1 != 1 devices"),
                 id="overrides1-slice E"),
    pytest.param(["train.stage=dynamicrafter", "mesh.shard_opt_state=false"],
                 None, id="overrides2-slice E"),
    pytest.param(["train.stage=dynamicrafter", "mesh.data_axis=batch"],
                 None, id="overrides3-slice E"),
    pytest.param(["train.stage=dynamicrafter", "train.cond_frames=2"],
                 (NotImplementedError, "does not read"),
                 id="overrides6-does not read"),
])
def test_waiting_paths_name_their_slice(tmp_path, overrides, refusal):
    """Entries starting with -- are arguments; the others --set values.
    A refused setting raises naming why; an accepted one builds the run
    (model, mesh, the optimizer's plan, data) and saves its step 0."""
    args = [a for o in overrides for a in (
        [o] if o.startswith("--") else ["--set", o])]
    argv = ["--tiny", "--synthetic-data", "--device", "cpu", "--logdir",
            str(tmp_path), "--max-steps", "0", "--logger", "none", *args]
    if refusal is None:
        assert trainer.run(argv).step == 0
        assert any(tmp_path.glob("*/checkpoints/step_0/params.pt"))
        return
    with pytest.raises(refusal[0], match=refusal[1]):
        trainer.run(argv)


def test_load_config_matches_jax(monkeypatch):
    """A shipped config file and dotted overrides through both packages'
    load_config: every field the port has is equal."""
    from open_pandora_tpu.core.config import load_config as jax_load_config

    paths = [str(REPO / "configs" / "finetune.yaml")]
    overrides = ["train.stage=dynamicrafter", "train.log_every=1",
                 "train.use_ema=true", "unet.channel_mult=1,2",
                 "diffusion.scale_factor=0.5"]
    ours = load_config(paths, overrides)
    theirs = jax_load_config(paths, overrides)
    for f in dataclasses.fields(ours):
        mine, ref = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            mine, ref = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert mine == ref, f.name
    assert (ours.train.log_every, ours.train.max_steps,
            ours.unet.channel_mult) == (1, 200_000, (1, 2))
    with pytest.raises(KeyError, match="train.nope"):
        load_config((), ["train.nope=1"])
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(RuntimeError, match="PyYAML"):
        load_config(paths)


def test_full_width_train_step_launches_as_predicted(monkeypatch):
    """PandoraConfig() at 320x512, batch 1, bf16, in training on the meta
    device: the dispatcher routes as on a CUDA device, the kernels are
    stand-ins that count, and one forward and backward (checkpointing on)
    launches 20 flash, 68 small, 10 flash backward and 34 small backward,
    the UNet's share of chip_smoke's per-step prediction."""
    calls = collections.Counter()

    def fwd(name, with_lse):
        def launch(q, k, v, **kw):
            calls[name] += 1
            o = torch.empty_like(q)
            if with_lse:
                return o, torch.empty(q.shape[0], q.shape[2], q.shape[1],
                                      device=q.device)
            return o
        return launch

    def bwd(name):
        def launch(q, k, v, *rest, **kw):
            calls[name] += 1
            return torch.empty_like(q), torch.empty_like(k), \
                torch.empty_like(v)
        return launch

    def attention(q, k, v, causal=False, mask=None, sm_scale=None):
        route = attention_route(q.shape, k.shape, causal=causal,
                                masked=mask is not None, on_device=True)
        if route == "flash":
            return tfa.flash_attention(q, k, v, causal=causal,
                                       sm_scale=sm_scale)
        if route == "small":
            return tsa.small_attention(q, k, v, sm_scale=sm_scale)
        return mha(q, k, v, causal=causal, mask=mask, sm_scale=sm_scale)

    monkeypatch.setattr(tfa, "_flash_cuda", fwd("flash", True))
    monkeypatch.setattr(tfa, "_flash_bwd_cuda", bwd("flash_bwd"))
    monkeypatch.setattr(tsa, "_small_cuda", fwd("small", False))
    monkeypatch.setattr(tsa, "_small_bwd_cuda", bwd("small_bwd"))
    monkeypatch.setattr(tunet, "attention", attention)
    cfg = PandoraConfig()
    u = cfg.unet
    with torch.device("meta"):
        model = tunet.UNetModel(u).to(torch.bfloat16)
    model.train()
    t, hz, wz = u.temporal_length, 40, 64
    x = torch.empty(1, t, hz, wz, u.in_channels, dtype=torch.bfloat16,
                    device="meta")
    ctx = torch.empty(1, u.text_context_len + t * u.img_tokens_per_frame,
                      u.context_dim, dtype=torch.bfloat16, device="meta")
    out = model(x, torch.zeros(1, dtype=torch.int64, device="meta"), ctx)
    out.float().sum().backward()
    blk = model.input_blocks[1]
    assert blk[1].transformer_blocks[0].attn1.to_q.weight.grad is not None
    assert blk[2].transformer_blocks[0].attn1.to_q.weight.grad is not None
    want = chip_smoke.predicted_train_launches(cfg, 320, 512, batch=1,
                                               frames=17, bf16=True)
    vae = chip_smoke.predicted_launches(cfg, 320, 512, 1, frame_chunk=1,
                                        fused=True)["encode"]
    assert dict(calls) == {"flash": 20, "small": 68, "flash_bwd": 10,
                           "small_bwd": 34}
    assert {k: want[k] - 17 * vae[k] for k in calls} == dict(calls)
    assert (want["flash"], want["group_norm"]) == (37, 374)


def test_fp32_train_step_prediction():
    """chip_smoke phase 6b's per-step prediction under dtype_policy=fp32:
    the UNet in training takes the unfused route at any dtype (the traced
    bf16 step above), and the VAE's 17 encodes run one flash launch each
    and, in fp32, the plain GroupNorm: 37 flash and 10 flash backward a
    step, no GroupNorm kernel."""
    cfg = PandoraConfig()
    want = chip_smoke.predicted_train_launches(cfg, 320, 512, batch=1,
                                               frames=17, bf16=False)
    assert {k: v for k, v in want.items() if v} == {
        "flash": 37, "flash_bwd": 10, "small": 68, "small_bwd": 34}


def test_llm_stage_launches_as_predicted():
    """chip_smoke's per-step prediction for phase 8 at full width
    (PandoraConfig(), 320x512, batch 1), from the routing functions alone:
    finetune launches the dynamicrafter step's kernels (its UNet and VAE),
    and no attention of the LLM side (the CLIP tower, the 192-row LLaMA
    prefill, masked in llm_sft, the Q-Former, the OpenCLIP encoders, the
    Resampler) takes a kernel route, so alignment and llm_sft launch
    nothing."""
    cfg = PandoraConfig()
    plen = chip_smoke.llm_prompt_len(cfg)
    assert plen == 192
    want = {stage: chip_smoke.predicted_llm_stage_launches(
        cfg, stage, 320, 512, 1, plen)
        for stage in ("alignment", "finetune", "llm_sft")}
    assert want["finetune"] == chip_smoke.predicted_train_launches(
        cfg, 320, 512, batch=1, frames=17, bf16=True)
    assert {k: v for k, v in want["finetune"].items() if v} == {
        "flash": 37, "flash_bwd": 10, "small": 68, "small_bwd": 34,
        "group_norm": 374}
    assert not any(want["alignment"].values())
    assert not any(want["llm_sft"].values())
    for stage in want:
        sites = chip_smoke.llm_attention_sites(cfg, stage, 1, plen)
        assert len(sites) == {"alignment": 5, "finetune": 7,
                              "llm_sft": 2}[stage]
        for q, k, causal, masked, calls, _ in sites:
            assert calls > 0
            assert attention_route(q, k, causal=causal, masked=masked,
                                   on_device=True) == "plain", (stage, q, k)


def _flat(tree, prefix=""):
    """{dotted.path: leaf} of a nested dict."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = val
    return out


@pytest.mark.parametrize("name", sorted(
    p.name for p in (REPO / "configs").glob("*.yaml")))
def test_shipped_config_loads_as_in_jax(name):
    """Every shipped config file through both packages' load_config: the
    flattened dataclasses.asdict trees are equal, key for key (alignment.yaml
    sets the root switch do_alignment)."""
    from open_pandora_tpu.core.config import load_config as jax_load_config

    path = [str(REPO / "configs" / name)]
    ours = _flat(dataclasses.asdict(load_config(path)))
    theirs = _flat(dataclasses.asdict(jax_load_config(path)))
    assert ours == theirs
