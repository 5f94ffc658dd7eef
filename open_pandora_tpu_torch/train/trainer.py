"""Training entry point of the port: the `dynamicrafter` stage (UNet only,
no LLM in the loop), on one device.

Counterpart of open_pandora_tpu/train/trainer.py (reference
trainer.py:24-105, utils/utils_train.py): config merge, workspace, model
and params in the config's dtype policy, the finetune step, metrics.jsonl,
checkpoints every ckpt_every steps and at the end, auto-resume.

Usage:
  python -m open_pandora_tpu_torch.train.trainer --synthetic-data \\
      --set train.stage=dynamicrafter --max-steps N [--name run1]
      [--logdir ./runs] [--config cfg.yaml]... [--set key.path=value]...
      [--ckpt model.ckpt] [--tiny] [--auto-resume] [--device cpu]

It runs on the CUDA card unless `--device cpu` is given. `--tiny` takes the
port's small config (eval/inference.debug_config, 32x32 frames). Waiting
for later slices: the alignment, finetune and llm_sft stages (slice B, the
LLM conditioning), WebVid data (OpenCV), multi-device runs (slice E; a
config's `mesh` section may only ask for one device) and `--sample-every`.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import sys
import time

import torch

log = logging.getLogger("open_pandora_tpu_torch.train")

# stages of the JAX trainer that need a slice not ported yet
WAITING = {
    "alignment": "slice B (LLM conditioning: connector, LLaMA, CLIP tower)",
    "finetune": "slice B (LLM conditioning: connector, LLaMA, CLIP tower)",
    "llm_sft": "slice B (LLM conditioning: LLaMA and its SFT data)",
}

# settings the config accepts, as the JAX package's does, that no ported
# code reads, with the reason; run() refuses a value other than the default
UNREAD = {
    ("mesh", "data_axis"): "it waits for slice E (multi-GPU)",
    ("mesh", "model_axis"): "it waits for slice E (multi-GPU)",
    ("mesh", "shard_opt_state"): "it waits for slice E (multi-GPU)",
    ("train", "frame_stride"): "it waits for WebVid data (OpenCV)",
    ("train", "fixed_fps"): "it waits for WebVid data (OpenCV)",
    ("train", "cond_frames"): "the JAX package's trainer does not read it "
                              "either",
}


def build_parser():
    p = argparse.ArgumentParser("open-pandora-torch-trainer")
    p.add_argument("--name", default=time.strftime("run_%Y%m%dT%H%M%S"))
    p.add_argument("--logdir", default="./runs")
    p.add_argument("--config", action="append", default=[],
                   help="YAML config file(s), merged in order (PyYAML)")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   help="dotted config overrides, e.g. train.log_every=1")
    p.add_argument("--ckpt", default=None,
                   help="initial weights: a reference DynamiCrafter "
                        "checkpoint (random weights without it)")
    p.add_argument("--auto-resume", action="store_true")
    p.add_argument("--synthetic-data", action="store_true")
    p.add_argument("--max-steps", type=int, default=None)
    p.add_argument("--tiny", action="store_true",
                   help="the small debug config (smoke mode)")
    p.add_argument("--device", default="cuda")
    return p


def run(argv=None):
    """Train as the command line says; returns the final TrainState."""
    from open_pandora_tpu_torch.core.checkpoint import (
        find_latest_checkpoint, init_workspace, restore_params, save_params)
    from open_pandora_tpu_torch.core.config import load_config, param_dtype
    from open_pandora_tpu_torch.data.webvid import (PrefetchLoader,
                                                    SyntheticVideoDataset)
    from open_pandora_tpu_torch.eval.inference import (build_model,
                                                       debug_config,
                                                       load_checkpoint)
    from open_pandora_tpu_torch.train.step import (TrainState,
                                                   make_finetune_step)
    from open_pandora_tpu_torch.utils.loggers import MetricsLogger

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to train on "
                           "the CPU")
    if not args.synthetic_data:
        raise NotImplementedError("WebVid data waits for OpenCV on the "
                                  "card's machine; pass --synthetic-data")
    if args.tiny:
        cfg = load_config(args.config, args.overrides, base=debug_config())
        height = width = 32
        video_len = cfg.unet.temporal_length
    else:
        cfg = load_config(args.config, args.overrides)
        height, width = cfg.train.height, cfg.train.width
        video_len = cfg.train.video_length
    tcfg = cfg.train
    if args.max_steps is not None:
        tcfg = dataclasses.replace(tcfg, max_steps=args.max_steps)
    stage = tcfg.stage
    if stage in WAITING:
        raise NotImplementedError(f"stage {stage!r} waits for "
                                  f"{WAITING[stage]}")
    if stage != "dynamicrafter":
        raise ValueError(f"unknown stage {stage!r}")
    if cfg.mesh.model_parallel != 1 or cfg.mesh.data_parallel not in (-1, 1):
        raise NotImplementedError(f"mesh {cfg.mesh}: more than one device "
                                  "waits for slice E (multi-GPU)")
    for (section, name), waits in UNREAD.items():
        node = getattr(cfg, section)
        if getattr(node, name) != getattr(type(node)(), name):
            raise NotImplementedError(
                f"{section}.{name}={getattr(node, name)!r}: the port does "
                f"not read this setting ({waits}); leave it at its default")

    ws = init_workspace(args.logdir, args.name, cfg)
    torch.manual_seed(tcfg.seed)   # the UNet's dropout masks
    model = build_model(cfg, device=device, dtype=param_dtype(
        cfg.dtype_policy), generator=torch.Generator(device=device)
        .manual_seed(tcfg.seed))
    if args.ckpt:
        load_checkpoint(model, args.ckpt)
    state = TrainState.create(model, stage, tcfg)
    step_fn = make_finetune_step(model, tcfg, stage)
    log.info("stage=%s device=%s dtype=%s trainable=%d", stage, device,
             model.dtype, sum(p.numel() for p in state.trainable.values()))

    if args.auto_resume:
        latest = find_latest_checkpoint(ws["checkpoints"])
        if latest:
            log.info("resuming from %s", latest)
            restore_params(latest, state.trainable)
            state.step = int(os.path.basename(latest)[5:])

    loader = PrefetchLoader(
        SyntheticVideoDataset(video_length=video_len,
                              resolution=(height, width),
                              clip_size=cfg.clip_vision.image_size),
        tcfg.batch_size_per_device, text_len=cfg.clip_text.context_length)
    metrics = MetricsLogger(ws["loginfo"])
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    t_last, step_last = time.perf_counter(), state.step
    epoch = 0
    try:
        while state.step < tcfg.max_steps:
            for batch in loader.epoch(epoch):
                m = step_fn(state, batch, generator=gen)
                if state.step % tcfg.log_every == 0 or state.step == 1:
                    m = {k: float(v) for k, v in m.items()}   # synchronises
                    now = time.perf_counter()
                    rec = {"sec_per_step": (now - t_last)
                           / (state.step - step_last), **m}
                    t_last, step_last = now, state.step
                    log.info("%s", {"step": state.step, **rec})
                    metrics.log(state.step, rec)
                if state.step % tcfg.ckpt_every == 0:
                    save_params(ws["checkpoints"], state.trainable,
                                state.step)
                    log.info("checkpoint @ step %d", state.step)
                if state.step >= tcfg.max_steps:
                    break
            epoch += 1
        save_params(ws["checkpoints"], state.trainable, state.step)
    finally:
        metrics.close()
    log.info("done at step %d", state.step)
    return state


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
