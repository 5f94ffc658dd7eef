"""PyTorch port, the trainer: the CLI end to end on the CPU (tiny config,
synthetic data, two steps, then an --auto-resume run to step 3) in a
process where importing jax fails; the stages and meshes that wait for
later slices; load_config against the JAX package's; and the kernel
launches of a full-width training step, traced on the meta
device through stand-in launchers, against chip_smoke's prediction."""

import collections
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chip_smoke
from open_pandora_tpu_torch.core.checkpoint import find_latest_checkpoint
from open_pandora_tpu_torch.core.config import PandoraConfig, load_config
from open_pandora_tpu_torch.models import unet3d as tunet
from open_pandora_tpu_torch.ops import flash_attention as tfa
from open_pandora_tpu_torch.ops import small_attention as tsa
from open_pandora_tpu_torch.ops.attention import attention_route
from open_pandora_tpu_torch.ops.attention_xla import mha
from open_pandora_tpu_torch.train import trainer

REPO = Path(__file__).resolve().parent.parent


def _train(tmp_path, *extra):
    argv = ["--tiny", "--synthetic-data", "--device", "cpu", "--logdir",
            str(tmp_path), "--name", "run", "--set",
            "train.stage=dynamicrafter", "--set", "train.log_every=1",
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


@pytest.mark.parametrize("overrides,slice_", [
    (["train.stage=alignment"], "slice B"),
    (["train.stage=finetune"], "slice B"),
    (["train.stage=llm_sft"], "slice B"),
    (["train.stage=dynamicrafter", "mesh.data_parallel=2"], "slice E"),
    (["train.stage=dynamicrafter", "mesh.shard_opt_state=false"], "slice E"),
    (["train.stage=dynamicrafter", "mesh.data_axis=batch"], "slice E"),
    (["train.stage=dynamicrafter", "train.frame_stride=3"], "WebVid"),
    (["train.stage=dynamicrafter", "train.fixed_fps=8"], "WebVid"),
    (["train.stage=dynamicrafter", "train.cond_frames=2"], "does not read"),
])
def test_waiting_paths_name_their_slice(tmp_path, overrides, slice_):
    with pytest.raises(NotImplementedError, match=slice_):
        trainer.run(["--tiny", "--synthetic-data", "--device", "cpu",
                     "--logdir", str(tmp_path),
                     *[a for o in overrides for a in ("--set", o)]])


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
